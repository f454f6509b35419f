"""Port vs JAX: the Mat stage's data path and runner on a small synthetic
scan (`make_scene(atlas_res=48)`, 2 views, pano 32×64, 32² atlases).

  * The port's datasets read a dataset the JAX exporter wrote (cv2 PNGs
    and a JPEG preview): every cube-face tensor within 1e-6.
  * The port's exporter writes a dataset the port reads back, with the
    same photographs as the JAX exporter's.
  * `train --trainstage Mat` runs end to end through the port's CLI on
    the CPU, with the bench atlases, and a run continues from its
    checkpoint.
  * The runner's losses follow the JAX runner's through the whole
    schedule (mask pass, substages 0/1/2 with fresh Adam): both draw the
    JAX runner's own uniforms (injected into the port), both fetch
    radiance exactly; the stage-2 losses agree within 1e-3 relative, the
    final atlases within 1e-4 on every texel, and each seg class's
    roughness spread within 1e-5.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.config import ConfigFactory
from texir_code_tpu.data import datasets as JD
from texir_code_tpu.data.export import export_reference_layout as j_export
from texir_code_tpu.data.synthetic import make_scene
from texir_code_tpu.models.material import MaterialParams as JParams
from texir_code_tpu.train.material import MatTrainRunner as JRunner
from texir_code_tpu_torch import cli, convert
from texir_code_tpu_torch.config import _parse_value, parse_file
from texir_code_tpu_torch.data import datasets as TD
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.export import export_reference_layout as t_export
from texir_code_tpu_torch.data.synthetic import make_scene as t_make_scene
from texir_code_tpu_torch.train.material import MatTrainRunner as TRunner

torch.set_num_threads(2)  # six test workers share the host's cores

PANO = (32, 64)
CONF = os.path.join(os.path.dirname(__file__), "..", "configs",
                    "mat_synthetic.conf")


def _write_irt(path_mesh):
    rng = np.random.default_rng(1)
    irt = rng.uniform(0.5, 2.0, (32, 32, 3)).astype(np.float32)
    hdrio.write_hdr(path_mesh.replace("out1.obj", "irt.hdr"), irt, flip=True)


@pytest.fixture(scope="module")
def jax_data(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_export"))
    path = j_export(make_scene(atlas_res=48), out, n_views=2, pano_res=PANO)
    _write_irt(path)
    return path


@pytest.fixture(scope="module")
def port_data(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_export"))
    path = t_export(t_make_scene(atlas_res=48), out, n_views=2,
                    pano_res=PANO, device="cpu")
    _write_irt(path)
    return path


@pytest.mark.parametrize("cls", ["ImageCubeDerived", "ImageCubeSyn"])
def test_datasets_read_jax_export(jax_data, cls):
    a = getattr(JD, cls)(jax_data, resolution=PANO, hdr_exposure=0.0)
    b = getattr(TD, cls)(jax_data, resolution=PANO, hdr_exposure=0.0)
    assert a.ids == b.ids and len(b) == 2
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert x["id"] == y["id"]
        for k in ("color", "mask", "segs", "rgb_grad", "cam_to_world",
                  "cam_position"):
            assert x[k].shape == y[k].shape, k
            np.testing.assert_allclose(y[k], x[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        assert len(np.unique(y["segs"])) > 2
    if cls == "ImageCubeSyn":
        assert b.train_ids == a.train_ids
        np.testing.assert_allclose(b.gt_albedo, a.gt_albedo, rtol=1e-6)
        np.testing.assert_allclose(b.gt_roughness, a.gt_roughness)


def test_read_ids_and_extrinsics(jax_data):
    root = os.path.dirname(os.path.dirname(jax_data))
    assert TD.read_ids(root) == JD.read_ids(root)
    assert np.array_equal(TD.read_extrinsics(root), JD.read_extrinsics(root))


def test_port_export_reads_back(port_data, jax_data):
    ds = TD.ImageCubeSyn(port_data, resolution=PANO, hdr_exposure=0.0)
    item = ds[1]
    assert item["color"].shape == (6, 16, 16, 3)
    assert (item["mask"] == 1).all()
    assert np.isfinite(item["rgb_grad"]).all()
    # the same photographs as the JAX exporter's (same closest hits)
    for vid in ds.ids:
        a = hdrio.read_hdr(os.path.join(os.path.dirname(os.path.dirname(
            jax_data)), "hdr", vid, "ccm.hdr"))
        b = hdrio.read_hdr(os.path.join(os.path.dirname(os.path.dirname(
            port_data)), "hdr", vid, "ccm.hdr"))
        assert (np.abs(a - b) > 1e-2 * np.abs(a).max()).mean() < 1e-3
    assert ds.gt_albedo is not None and ds.gt_roughness is not None
    # and the same segmentation panos (a tie may pick another wall)
    for vid in ds.ids:
        a, b = (hdrio.read_gray(os.path.join(os.path.dirname(os.path.dirname(
            p)), "derived", vid, "panoImage_gray.png"))
            for p in (jax_data, port_data))
        assert (a != b).mean() < 2e-3


def test_image_io_matches_cv2(tmp_path):
    """The port's PNG reads equal the JAX package's cv2 reads; LDR and
    plot helpers agree."""
    import cv2

    from texir_code_tpu.data import hdrio as JH

    rng = np.random.default_rng(7)
    rgba = np.cumsum(rng.integers(0, 9, (13, 21, 4)), 1).astype(np.uint8)
    gray = np.cumsum(rng.integers(0, 9, (13, 21)), 0).astype(np.uint8)
    for name, img in (("rgba.png", rgba), ("gray.png", gray)):
        path = str(tmp_path / name)
        cv2.imwrite(path, img)
        np.testing.assert_array_equal(hdrio.read_image(path),
                                      JH.read_image(path))
        np.testing.assert_array_equal(hdrio.read_gray(path), JH.read_gray(path))
    hdr = rng.uniform(0, 3, (5, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(hdrio.tonemap_to_ldr(hdr),
                                  JH.tonemap_to_ldr(hdr))
    hdrio.plot_irf(str(tmp_path / "p.hdr"), hdr, hdr * 0.5)
    JH.plot_irf(str(tmp_path / "q.hdr"), hdr, hdr * 0.5)
    np.testing.assert_array_equal(hdrio.read_hdr(str(tmp_path / "p.hdr")),
                                  JH.read_hdr(str(tmp_path / "q.hdr")))
    cv2.imwrite(str(tmp_path / "x.jpg"), rgba[..., :3])
    assert hdrio.jpeg_size(str(tmp_path / "x.jpg")) == (13, 21)


def test_roomseg_matches_jax(tmp_path):
    from texir_code_tpu.train import material as JM
    from texir_code_tpu_torch.data.synthetic import make_roomseg
    from texir_code_tpu_torch.train import material as TM

    scale, w, h, x_min, z_min, img = make_roomseg(
        (8.0, 3.0, 5.0), lambda X, Z: 1 + (X >= 4.4) + (Z >= 3.0))
    d = tmp_path / "roomseg"
    d.mkdir()
    with open(d / "originOccupancyGrid_f0.meta", "w") as f:
        f.write(f"{scale} {int(w)} {int(h)} {x_min} {z_min}\n")
    hdrio.write_png(str(d / "roomSegs_uchar_f0.png"), img)
    a, b = JM.parse_roomseg(str(d)), TM.parse_roomseg(str(d))
    assert a[:5] == b[:5]
    np.testing.assert_array_equal(a[5], b[5])
    pos = np.random.default_rng(3).uniform(-0.5, 8.5, (6, 7, 7, 3))
    ids = TM.room_ids_at(b, pos)
    np.testing.assert_array_equal(ids, JM.room_ids_at(a, pos))
    assert set(np.unique(ids)) >= {1, 2, 3}


def test_png_codec_all_filters(tmp_path):
    """A PNG with each of the five scanline filters decodes exactly."""
    import struct
    import zlib

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (5, 7, 3)).astype(np.uint8)
    bpp, stride = 3, 21
    raw = bytearray()
    prev = np.zeros(stride, np.int64)
    for y, ftype in enumerate([0, 1, 2, 3, 4]):
        cur = img[y].reshape(-1).astype(np.int64)
        out = []
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            p = a + b - c
            paeth = a if abs(p - a) <= min(abs(p - b), abs(p - c)) else (
                b if abs(p - b) <= abs(p - c) else c)
            pred = [0, a, b, (a + b) // 2, paeth][ftype]
            out.append((cur[i] - pred) & 0xFF)
        raw += bytes([ftype]) + bytes(out)
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw)))
                + chunk(b"IEND", b""))
    assert np.array_equal(hdrio.read_png(path), img)
    hdrio.write_png(path, img)
    assert np.array_equal(hdrio.read_png(path), img)


def _mat_argv(path, exps):
    """The Mat stage on the CPU at pano 32×64 with the bench atlases
    (albedo 2048², roughness 4096²)."""
    return [
        "train", "--conf", CONF, "--trainstage", "Mat", "--device", "cpu",
        "--max_epochs", "1", "--exps_folder", exps,
        "--set", f"train.path_mesh_open3d={path}",
        "--set", f"train.pano_img_res=[{PANO[0]},{PANO[1]}]",
    ]


@pytest.fixture(scope="module")
def mat_run(port_data, tmp_path_factory):
    """One `train --trainstage Mat` run through the CLI (~30 s on the
    CPU): its exps root."""
    exps = str(tmp_path_factory.mktemp("mat_exps"))
    assert cli.main(_mat_argv(port_data, exps)) == 0
    return exps


def test_mat_cli_end_to_end_cpu(mat_run):
    (root,) = [r for r, _, f in os.walk(mat_run) if "timings.json" in f]
    plots = os.path.join(root, "plots")
    albedo = hdrio.read_hdr(os.path.join(plots, "mat_albedo_final.hdr"))
    rough = hdrio.read_hdr(os.path.join(plots, "mat_roughness_final.hdr"))
    for name in ("mat_albedo_final_padding.hdr",
                 "mat_roughness_final_padding.hdr"):
        assert os.path.exists(os.path.join(plots, name))
    assert np.isfinite(albedo).all() and np.isfinite(rough).all()
    assert albedo.shape == (2048, 2048, 3) and rough.shape == (4096, 4096, 3)
    assert albedo.min() >= 0
    # .hdr stores 8-bit mantissas: the clamp bounds within RGBE rounding
    assert rough.min() >= 0.0099 and rough.max() <= 0.8
    assert np.abs(albedo - 0.5).max() > 1e-3  # the optimizer moved it
    ckpt = os.path.join(root, "checkpoints", "ModelParameters")
    assert os.path.exists(os.path.join(ckpt, "LATEST"))


def test_mat_runner_continues_from_checkpoint(mat_run, port_data):
    """--is_continue restores the atlases the finished run saved."""
    conf = parse_file(CONF)
    for kv in _mat_argv(port_data, mat_run)[12::2]:  # the --set values
        k, _, v = kv.partition("=")
        conf.put(k, _parse_value(v))
    r = TRunner(conf, exps_root=mat_run, is_continue=True, device="cpu")
    (root,) = [d for d, _, f in os.walk(mat_run) if "timings.json" in f]
    assert r.exp.root == root
    saved = hdrio.read_hdr(os.path.join(root, "plots", "mat_albedo_final.hdr"))
    got = r.params.albedo.numpy()
    assert got.shape == (2048, 2048, 3) and np.abs(got - 0.5).max() > 1e-3
    # the .hdr copy keeps 8-bit mantissas; the checkpoint is exact
    np.testing.assert_allclose(saved, got, rtol=1e-2, atol=1e-3)


def test_cli_without_card_raises(port_data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    argv = _mat_argv(port_data, str(tmp_path / "exps"))
    argv.remove("--device")
    argv.remove("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def _losses(text, stage):
    return [float(x) for x in re.findall(
        rf"img_loss_stage{stage} \(L1\) = ([0-9.eE+-]+)", text)]


def test_runner_losses_follow_jax(jax_data, tmp_path, capsys):
    sets = {
        "train.path_mesh_open3d": jax_data,
        "train.pano_img_res": list(PANO),
        "train.mat_albedo_res": 32, "train.mat_roughness_res": 32,
        # both packages fetch radiance by exact bilinear (the JAX CPU path)
        "models.render.specular_fetch": "exact",
    }
    jconf = ConfigFactory.parse_file(CONF)
    tconf = parse_file(CONF)
    for k, v in sets.items():
        jconf.put(k, v)
        tconf.put(k, v)
    jr = JRunner(jconf, exps_root=str(tmp_path / "j"), max_epochs=1,
                 albedo_res=32, roughness_res=32)
    tr = TRunner(tconf, exps_root=str(tmp_path / "t"), max_epochs=1,
                 device="cpu")
    assert tr.model.num_uniforms == 5  # stochastic LOD + bilinear on

    def jax_draw(seed, b):
        """The JAX runner's uniforms for its n-th keyed call."""
        key = jax.random.fold_in(jax.random.PRNGKey(666),
                                 seed - TRunner.step_seed(0))
        rows = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.arange(b, dtype=jnp.int32))
        return torch.tensor(np.array(jax.vmap(
            lambda k: jax.random.uniform(k, (5,)))(rows)))

    tr.model.draw_spec_shift = jax_draw
    # from the same random atlases: at the constant init (roughness 0.1
    # everywhere) the stage-1 seg prior's L1 residuals are ±1 ulp, their
    # subgradient signs are rounding noise in either package, and Adam's
    # first step turns that noise into ±lr per texel
    rng = np.random.default_rng(4)
    albedo = rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.6, (32, 32, 1)).astype(np.float32)
    jr.params = JParams(jnp.asarray(albedo), jnp.asarray(rough))
    tr.params = convert.material_params_from_numpy(albedo, rough, device="cpu")
    out = {}
    for name, r in (("jax", jr), ("port", tr)):
        capsys.readouterr()
        r.build_masks()
        it = 0
        for stage in (0, 1, 2):
            it = r._substage(stage, 1, it)
        out[name] = capsys.readouterr().out
    for vid in jr.masks:
        for k in ("highlight", "seg_id", "seg_region", "room_id"):
            assert np.array_equal(jr.masks[vid][k], tr.masks[vid][k]), k
    for stage, rtol in ((0, 1e-4), (1, 1e-3), (2, 1e-3)):
        a, b = _losses(out["jax"], stage), _losses(out["port"], stage)
        assert len(a) == len(b) == 2
        np.testing.assert_allclose(b, a, rtol=rtol, err_msg=f"stage {stage}")
    # the final atlases, texel by texel (read: albedo within 1.1e-5,
    # roughness within 1.6e-6), and so each seg class's roughness spread
    for name in ("albedo", "roughness"):
        a = np.asarray(getattr(jr.params, name))
        b = getattr(tr.params, name).detach().numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=name)
    from texir_code_tpu_torch.models.tracer_irt import bake_geometry_textures

    scene = t_make_scene(atlas_res=48)
    idx = np.arange(32) * 48 // 32
    seg = scene.seg_texture[idx][:, idx]
    valid = bake_geometry_textures(scene.mesh, 32).valid
    a = np.asarray(jr.params.roughness)[..., 0]
    b = tr.params.roughness.detach().numpy()[..., 0]
    for c in np.unique(seg[valid]):
        m = valid & (seg == c)
        assert abs(b[m].std() - a[m].std()) < 1e-5, c
