"""Port vs JAX: the five offline tools (`texir_code_tpu_torch/tools/`:
relighting_varying, padding_texture, trans_hdr_tex, hdr2ldr, arrange_syn)
against the JAX package's on the same inputs.

The JAX tools read and write images through OpenCV (which this host has
and the machine with the card does not); the port's go through its own
codecs (data/hdrio.py).  Outputs are compared decoded: .hdr files and
8/16-bit PNGs equal value for value, except `trans_hdr_tex`'s 2048²
material resize, where OpenCV's 8-bit INTER_LINEAR may round a value one
level apart (at most one level, on at most 2% of the values; its 4×4
dilation is exact).  `relighting_varying` draws JAX's own uniforms (frame
f keyed PRNGKey(f)) and matches within rtol 1e-4 / atol 1e-5.
"""

import os
import shutil

import cv2
import jax
import numpy as np
import pytest
import torch

from texir_code_tpu.data import hdrio as JH
from texir_code_tpu.data.synthetic import make_scene as j_scene
from texir_code_tpu.tools import arrange_syn as j_arrange
from texir_code_tpu.tools import hdr2ldr as j_hdr2ldr
from texir_code_tpu.tools import padding_texture as j_pad
from texir_code_tpu.tools import relighting_varying as j_relight
from texir_code_tpu.tools import trans_hdr_tex as j_trans
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.synthetic import make_scene as t_scene
from texir_code_tpu_torch.eval import path_tracer as TP
from texir_code_tpu_torch.geometry.obj import save_obj
from texir_code_tpu_torch.tools import arrange_syn as t_arrange
from texir_code_tpu_torch.tools import hdr2ldr as t_hdr2ldr
from texir_code_tpu_torch.tools import padding_texture as t_pad
from texir_code_tpu_torch.tools import relighting_varying as t_relight
from texir_code_tpu_torch.tools import trans_hdr_tex as t_trans

from test_torch_path_tracer import jax_pano_draws

torch.set_num_threads(2)  # six test workers share the host's cores


def _hdr(rng, shape, lo=0.0, hi=4.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


# ----------------------------------------------------------------------
# relighting_varying


@pytest.fixture(scope="module")
def relight_inputs():
    js, ts = j_scene(atlas_res=32), t_scene(atlas_res=32)
    rng = np.random.default_rng(51)
    albedo = rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32)
    rough = rng.uniform(0.1, 0.6, (32, 32, 1)).astype(np.float32)
    return js, ts, albedo, rough, js.camera_positions(2)[0]


@pytest.mark.parametrize("mode", ["color", "move"])
def test_relighting_varying_matches_jax(relight_inputs, mode, monkeypatch):
    """Two frames (denoised) at 16x32, spp 2, from JAX's draws."""
    js, ts, albedo, rough, cam = relight_inputs
    kw = dict(num_frames=2, mode=mode, pano_res=(16, 32), spp=2)
    a = j_relight.render_sequence(js.mesh, albedo, rough, cam, **kw)
    monkeypatch.setattr(TP.PathTracedMaterialModel, "draws", jax_pano_draws(
        jax.random.PRNGKey, 16 * 32))
    b = t_relight.render_sequence(ts.mesh, albedo, rough, cam, device="cpu",
                                  **kw)
    assert len(a) == len(b) == 2
    for k, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(y, np.asarray(x), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{mode} frame {k}")
    assert not np.allclose(b[0], b[1])


def test_relighting_varying_cli(relight_inputs, tmp_path):
    """`main` writes the sequence's frames: those of render_sequence."""
    _, ts, albedo, rough, _ = relight_inputs
    mesh = str(tmp_path / "out1.obj")
    save_obj(mesh, ts.mesh)
    hdrio.write_hdr(str(tmp_path / "a.hdr"), albedo)
    hdrio.write_hdr(str(tmp_path / "r.hdr"), np.repeat(rough, 3, -1))
    out = str(tmp_path / "frames")
    assert t_relight.main(["--mesh", mesh, "--albedo", str(tmp_path / "a.hdr"),
                           "--roughness", str(tmp_path / "r.hdr"),
                           "--out-dir", out, "--frames", "2", "--spp", "1",
                           "--mode", "move", "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["relit_0000.hdr", "relit_0001.hdr"]
    from texir_code_tpu_torch.geometry import load_obj

    ref = t_relight.render_sequence(
        load_obj(mesh), hdrio.read_hdr(str(tmp_path / "a.hdr")),
        hdrio.read_hdr(str(tmp_path / "r.hdr"))[..., 0:1], [2.0, 1.5, 2.5],
        num_frames=2, mode="move", spp=1, device="cpu")
    for i, img in enumerate(ref):
        disk = hdrio.read_hdr(os.path.join(out, f"relit_{i:04d}.hdr"))
        assert disk.shape == (64, 128, 3)
        assert np.array_equal(disk, hdrio.rgbe_to_float(
            hdrio.float_to_rgbe(img)))
        assert np.isfinite(disk).all() and disk.max() > 0


# ----------------------------------------------------------------------
# padding_texture


def _seamed(rng):
    tex = np.zeros((24, 24, 3), np.float32)
    tex[4:12, 3:20] = _hdr(rng, (8, 17, 3), 0.5, 2.0)
    tex[15:22, 6:14] = _hdr(rng, (7, 8, 3), 0.5, 2.0)
    return tex


def test_pad_and_denoise_matches_jax():
    tex = _seamed(np.random.default_rng(52))
    for denoise in (False, True):
        a = np.asarray(j_pad.pad_and_denoise(tex, denoise=denoise))
        b = t_pad.pad_and_denoise(tex, denoise=denoise, device="cpu")
        if denoise:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        else:
            assert np.array_equal(a, b)
        assert (b.sum(-1) > 0).all()


@pytest.mark.parametrize("flags", [["--no-denoise"], []])
def test_padding_texture_cli_matches_jax(tmp_path, flags):
    tex = _seamed(np.random.default_rng(53))
    src = str(tmp_path / "in.hdr")
    hdrio.write_hdr(src, tex)
    ja, tb = str(tmp_path / "j.hdr"), str(tmp_path / "t.hdr")
    assert j_pad.main([src, ja] + flags) == 0
    assert t_pad.main([src, tb, "--device", "cpu"] + flags) == 0
    a, b = hdrio.read_hdr(ja), hdrio.read_hdr(tb)
    if flags:
        assert np.array_equal(a, b)
    else:  # RGBE keeps 8 mantissa bits: a float32 rounding may flip one
        np.testing.assert_allclose(b, a, rtol=1e-2)


def test_padding_texture_index_mode_matches_jax(tmp_path):
    """--index: a uint16 index texture written by OpenCV, padded bit-exact
    by both tools; the port's 16-bit PNG reads back as OpenCV reads it."""
    rng = np.random.default_rng(54)
    idx = np.zeros((16, 20, 3), np.uint16)
    idx[4:12, 3:15] = rng.integers(1, 50000, (8, 12, 3), dtype=np.uint16)
    src = str(tmp_path / "in.png")
    cv2.imwrite(src, idx)
    ja, tb = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    assert j_pad.main([src, ja, "--index"]) == 0
    assert t_pad.main([src, tb, "--index"]) == 0
    a, b = cv2.imread(ja, -1), cv2.imread(tb, -1)
    assert a.dtype == b.dtype == np.uint16
    assert np.array_equal(a, b)
    assert np.array_equal(b[4:12, 3:15], idx[4:12, 3:15])
    assert (b.sum(-1) > 0).all()
    with pytest.raises(ValueError, match="no non-zero texel"):
        t_pad.pad_index_texture(np.zeros((4, 4, 3), np.uint16))


# ----------------------------------------------------------------------
# trans_hdr_tex


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A scan project: two views with panos of their own resolution, an
    OpenCV-written uint16 index texture (BGR = row, col, view), seg and
    method predictions (8-bit)."""
    root = str(tmp_path_factory.mktemp("proj") / "p")
    rng = np.random.default_rng(55)
    ids = ["scanA", "scanB"]
    os.makedirs(os.path.join(root, "info"))
    with open(os.path.join(root, "info", "aligned.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    for vid, (h, w) in zip(ids, [(16, 32), (24, 48)]):
        for sub in ("hdr", "derived", "methods/phyir"):
            os.makedirs(os.path.join(root, sub, vid))
        hdrio.write_hdr(os.path.join(root, "hdr", vid, "ccm.hdr"),
                        _hdr(rng, (h, w, 3)))
        cv2.imwrite(os.path.join(root, "derived", vid, "panoImage_gray.png"),
                    rng.integers(0, 40, (h, w), dtype=np.uint8))
        cv2.imwrite(os.path.join(root, "methods/phyir", vid, "albedo.png"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        cv2.imwrite(os.path.join(root, "methods/phyir", vid,
                                 "roughness.png"),
                    rng.integers(0, 256, (h, w), dtype=np.uint8))
    idx = np.zeros((40, 40, 3), np.uint16)
    idx[..., 0] = rng.integers(0, 50000, (40, 40))
    idx[..., 1] = rng.integers(0, 50000, (40, 40))
    idx[..., 2] = rng.integers(0, 2, (40, 40))
    idx[:6] = 0  # an unmapped seam
    os.makedirs(os.path.join(root, "hdr_texture"))
    cv2.imwrite(os.path.join(root, "hdr_texture", "0.png"), idx)
    return root


@pytest.mark.parametrize("target,name", [
    ("hdr", "0_hdr_ccm_upper.hdr"), ("seg", "0_seg_gray.png"),
    ("albedo", "0_phyir_albedo.png"), ("roughness", "0_phyir_roughness.png"),
])
def test_trans_hdr_tex_matches_jax(project, tmp_path, target, name):
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(project, jp)
    shutil.copytree(project, tp)
    assert j_trans.main([target, "--project", jp]) == 0
    assert t_trans.main([target, "--project", tp]) == 0
    ja = os.path.join(jp, "hdr_texture", name)
    tb = os.path.join(tp, "hdr_texture", name)
    if target == "hdr":
        a, b = hdrio.read_hdr(ja), hdrio.read_hdr(tb)
        assert np.array_equal(a, b)
        assert (b[:6] == 0).all() and (b[6:].sum(-1) > 0).mean() > 0.99
        return
    a, b = hdrio.read_png(ja), hdrio.read_png(tb)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    if target == "seg":
        assert np.array_equal(a, b)
        return
    assert a.shape == (2048, 2048, 3)
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= 0.02, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("shape,size", [
    ((40, 40, 3), (2048, 2048)), ((37, 53, 3), (100, 60)),
    ((300, 200, 3), (64, 64)), ((7, 9), (13, 20)),
])
def test_resize_and_dilate_match_cv2(shape, size):
    img = np.random.default_rng(56).integers(0, 256, shape, dtype=np.uint8)
    a, b = cv2.resize(img, size), t_trans.resize_linear(img, size)
    assert a.shape == b.shape
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= 0.02, (d.max(), (d > 0).mean())
    assert np.array_equal(t_trans.dilate(img, 4),
                          cv2.dilate(img, np.ones((4, 4), np.uint8)))


def test_trans_hdr_tex_decode_matches_jax(project):
    idx = cv2.imread(os.path.join(project, "hdr_texture", "0.png"), -1)
    _, port = t_trans._read_index(project)
    assert np.array_equal(idx, port)
    for x, y in zip(j_trans.decode_index_texture(idx),
                    t_trans.decode_index_texture(port)):
        assert np.array_equal(x, y)


# ----------------------------------------------------------------------
# hdr2ldr and arrange_syn


def test_hdr2ldr_matches_jax(tmp_path):
    rng = np.random.default_rng(57)
    srcs = []
    for i in range(2):
        srcs.append(str(tmp_path / f"f{i}.hdr"))
        hdrio.write_hdr(srcs[-1], _hdr(rng, (12, 20, 3), 0.0, 3.0))
    assert j_hdr2ldr.main(srcs + ["--out-dir", str(tmp_path / "j")]) == 0
    assert t_hdr2ldr.main(srcs + ["--out-dir", str(tmp_path / "t")]) == 0
    for i in range(2):
        a = hdrio.read_png(str(tmp_path / "j" / f"f{i}.png"))
        b = hdrio.read_png(str(tmp_path / "t" / f"f{i}.png"))
        assert a.shape == (12, 20, 3) and np.array_equal(a, b)


def test_arrange_syn_matches_jax(tmp_path):
    """The same dataset layout; the LDR preview is a PNG in the port (no
    JPEG encoder), equal to what the JAX writer puts in a PNG."""
    rng = np.random.default_rng(58)
    src = tmp_path / "renders"
    src.mkdir()
    for i in range(3):
        hdrio.write_hdr(str(src / f"v{i}.hdr"), _hdr(rng, (8, 16, 3)))
    hdrio.write_hdr(str(src / "v0_albedo.hdr"), _hdr(rng, (8, 8, 3), 0, 1))
    hdrio.write_hdr(str(src / "v0_roughness.hdr"), _hdr(rng, (8, 8, 3), 0, 1))
    np.savetxt(str(src / "extrinsics.txt"), rng.normal(size=(12, 4)))
    mesh_dir = tmp_path / "mesh"
    mesh_dir.mkdir()
    save_obj(str(mesh_dir / "out1.obj"), t_scene(atlas_res=8).mesh)
    hdrio.write_hdr(str(mesh_dir / "irt.hdr"), _hdr(rng, (4, 4, 3)))
    args = ["--src", str(src), "--mesh", str(mesh_dir / "out1.obj"),
            "--hdr-scale", "-1", "--novel", "2", "--skip", "1"]
    assert j_arrange.main(args + ["--out", str(tmp_path / "j")]) == 0
    assert t_arrange.main(args + ["--out", str(tmp_path / "t")]) == 0

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    jt, tt = tree(str(tmp_path / "j")), tree(str(tmp_path / "t"))
    assert [p.replace(".jpg", ".png") for p in jt] == tt
    assert "hdr/view002/ccm.hdr" in tt and "hdr/view001/ccm.hdr" not in tt
    for rel in tt:
        a = os.path.join(str(tmp_path / "j"), rel)
        b = os.path.join(str(tmp_path / "t"), rel)
        if rel.endswith("panoImage_orig.png"):
            ref = str(tmp_path / "ref.png")
            JH.write_png(ref, JH.tonemap_to_ldr(JH.read_hdr(
                a.replace("derived", "hdr").replace("panoImage_orig.png",
                                                    "ccm.hdr"))))
            assert np.array_equal(hdrio.read_png(ref), hdrio.read_png(b))
            assert hdrio.jpeg_size(a.replace(".png", ".jpg")) == (8, 16)
        elif rel.endswith(".hdr"):
            assert np.array_equal(hdrio.read_hdr(a), hdrio.read_hdr(b)), rel
        elif rel.endswith(".png"):
            assert np.array_equal(hdrio.read_png(a), hdrio.read_png(b)), rel
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
