"""Port vs JAX: the IrrT bake — bake_batch texel for texel, the post-pass,
and the port CLI's IrrT stage end to end on the CPU.

bake_batch runs on the same packed scene (convert.py) with the uniforms the
JAX baker itself draws (`stratified_samples` with per-texel fold_in keys)
injected through `samples=`.  The walk then agrees to ~1e-6 and the
estimator sums 512 rays per texel in another order, so texels are held to
rtol 1e-5; one ray crossing a texel edge of the nearest RGBE fetch would
break that, and on this input none does (measured max rel ~2e-7).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.synthetic import make_apartment_scene
from texir_code_tpu.geometry.bvh import build_bvh
from texir_code_tpu.geometry.obj import save_obj
from texir_code_tpu.geometry.occluders import extract_occluders
from texir_code_tpu.models.tbl import build_tbl
from texir_code_tpu.models.tracer_irt import (
    IrradianceTextureBaker as JBaker,
    bake_geometry_textures as j_geometry,
    morton_order,
)
from texir_code_tpu.ops.fan_raycast import FanScene
from texir_code_tpu.ops.pallas_culled import ClusterScene
from texir_code_tpu.ops.postprocess import atrous_denoise as j_atrous
from texir_code_tpu.ops.postprocess import pad_texture as j_pad
from texir_code_tpu.ops.sampling import stratified_samples
from texir_code_tpu_torch import cli, convert
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.models.tracer_irt import (
    IrradianceTextureBaker as TBaker,
    bake_geometry_textures as t_geometry,
)
from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
from texir_code_tpu_torch.ops.postprocess import atrous_denoise as t_atrous
from texir_code_tpu_torch.ops.postprocess import pad_texture as t_pad
from texir_code_tpu_torch.train.exp import seed_everything

TEXELS, SPP, SEED = 64, 512, 1234


@pytest.fixture(scope="module")
def apartment():
    return make_apartment_scene(atlas_res=64, subdiv=6)


@pytest.mark.parametrize("supersample", [2, 0])
def test_bake_batch_matches_jax(apartment, supersample):
    # supersample 2: the prefiltered 1-fetch atlas (the default);
    # 0: the exact 4-fetch bilinear atlas
    syn = apartment
    bvh = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(bvh, triangle_uvs=syn.mesh.triangle_uvs())
    jc = ClusterScene.from_fan(fan, lb=4, dense=True)
    jo = extract_occluders(syn.mesh)
    jt = build_tbl(syn.mesh, syn.hdr_texture)

    geom = j_geometry(syn.mesh, 32)
    vr, vc = np.nonzero(geom.valid)
    order = morton_order(geom.position[vr, vc])
    sel = order[:: len(order) // TEXELS][:TEXELS]
    pts = geom.position[vr[sel], vc[sel]]
    nrm = geom.normal[vr[sel], vc[sel]]
    ids = np.arange(100, 100 + TEXELS, dtype=np.int32)

    jb = JBaker(jt, spp=SPP, texel_batch=TEXELS, cluster_scene=jc, wedges=4,
                pallas_interpret=True)
    jb.fan_block, jb.exit_rows, jb.occluders = 32, 16, jo
    jb.rgbe_supersample = supersample
    ref = np.asarray(jb.bake_batch(jnp.asarray(pts), jnp.asarray(nrm),
                                   jnp.asarray(ids), jnp.int32(SEED)))

    row_keys = jax.vmap(
        lambda i: jax.random.fold_in(jax.random.PRNGKey(SEED), i)
    )(jnp.asarray(ids))
    samples = np.array(stratified_samples(
        jax.random.PRNGKey(SEED), TEXELS, SPP, "hammersley", row_keys))

    tc = convert.cluster_scene_from_numpy(
        np.asarray(jc.rows3), np.asarray(jc.prims3),
        np.asarray(jc.cluster_lo), np.asarray(jc.cluster_hi),
        float(jc.diameter), jc.lb, jc.has_uv, device="cpu")
    tt = convert.tbl_from_numpy(np.asarray(jt.uv_u), np.asarray(jt.uv_v),
                                [np.asarray(p) for p in jt.planes],
                                device="cpu")
    to = convert.occluders_from_numpy(
        jo.axis, np.asarray(jo.p), np.asarray(jo.rect_lo),
        np.asarray(jo.rect_hi), float(jo.sep_margin), device="cpu")
    tb = TBaker(tt, spp=SPP, texel_batch=TEXELS, cluster_scene=tc, wedges=4)
    tb.fan_block, tb.exit_rows, tb.occluders = 32, 16, to
    tb.rgbe_supersample = supersample
    got = tb.bake_batch(torch.from_numpy(pts), torch.from_numpy(nrm),
                        torch.from_numpy(ids), SEED,
                        samples=torch.from_numpy(samples)).numpy()
    assert ref.shape == got.shape == (TEXELS, 3)
    assert ref.mean() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_geometry_textures_match_jax(apartment):
    a = j_geometry(apartment.mesh, 48)
    b = t_geometry(apartment.mesh, 48)
    for name in ("position", "normal", "valid"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_pad_and_denoise_match_jax(rng):
    img = (rng.random((24, 20, 3)) * 5).astype(np.float32)
    valid = rng.random((24, 20)) > 0.3
    np.testing.assert_array_equal(j_pad(img, valid), t_pad(img, valid))
    a = np.asarray(j_atrous(jnp.asarray(img)))
    b = t_atrous(torch.from_numpy(img)).numpy()
    # 3 passes of 25-tap weighted sums (exp of range weights), float32
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def _write_scene(syn, root):
    mesh_dir = os.path.join(root, "mesh")
    os.makedirs(mesh_dir)
    path = os.path.join(mesh_dir, "out1.obj")
    save_obj(path, syn.mesh)
    hdrio.write_hdr(os.path.join(mesh_dir, "hdr_texture.hdr"),
                    syn.hdr_texture, flip=True)
    return path


def _conf():
    return os.path.join(os.path.dirname(__file__), "..", "configs",
                        "irt_synthetic.conf")


def test_cli_irrt_end_to_end_cpu(apartment, tmp_path):
    path = _write_scene(apartment, str(tmp_path))
    before = dict(culled_walk_cuda.launches)
    rc = cli.main([
        "train", "--conf", _conf(), "--trainstage", "IrrT", "--irt_res", "24",
        "--exps_folder", str(tmp_path / "exps"), "--device", "cpu",
        "--set", f"train.path_mesh_open3d={path}",
        "--set", "train.sample_light=[512, 16]",
    ])
    assert rc == 0
    raw = hdrio.read_hdr(path.replace("out1.obj", "0_irr_texture.hdr"), flip=True)
    irt = hdrio.read_hdr(path.replace("out1.obj", "irt.hdr"), flip=True)
    valid = t_geometry(apartment.mesh, 24).valid
    assert raw.shape == irt.shape == (24, 24, 3)
    assert np.isfinite(irt).all() and (irt > 0).all()  # padded everywhere
    assert (raw[~valid] == 0).all() and raw[valid].mean() > 0.1
    assert os.path.isdir(tmp_path / "exps" / "IrrT-default")
    assert culled_walk_cuda.launches == before  # CPU: the plain walk


def test_cli_unported_stage_names_roadmap(tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP.md queue A item 9"):
        cli.main(["train", "--conf", _conf(), "--trainstage", "MatSyn"])


def test_runner_unported_knob_raises(apartment, tmp_path):
    path = _write_scene(apartment, str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main([
            "train", "--conf", _conf(), "--trainstage", "IrrT",
            "--exps_folder", str(tmp_path / "exps"), "--device", "cpu",
            "--set", f"train.path_mesh_open3d={path}",
            "--set", "train.two_pass_cut=0.25",
        ])


def test_seed_everything_returns_generator():
    a = seed_everything(666)
    b = seed_everything(666)
    assert isinstance(a, torch.Generator)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
