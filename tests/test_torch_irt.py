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
from texir_code_tpu.ops.sampling import (
    hammersley_azimuth_sorted,
    stratified_samples,
)
from texir_code_tpu_torch import cli, convert
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.geometry.bvh import FlatBVH
from texir_code_tpu_torch.models.tracer_irt import (
    IrradianceTextureBaker as TBaker,
    bake_geometry_textures as t_geometry,
)
from texir_code_tpu_torch.ops import fan_raycast as TF
from texir_code_tpu_torch.ops import pallas_culled as TC
from texir_code_tpu_torch.ops.pallas_culled import culled_walk_cuda
from texir_code_tpu_torch.ops.postprocess import atrous_denoise as t_atrous
from texir_code_tpu_torch.ops.postprocess import pad_texture as t_pad
from texir_code_tpu_torch.train.exp import seed_everything

torch.set_num_threads(2)  # six test workers share the host's cores

TEXELS, SPP, SEED = 64, 512, 1234


@pytest.fixture(scope="module")
def apartment():
    return make_apartment_scene(atlas_res=64, subdiv=6)


@pytest.fixture(scope="module")
def bake_setup(apartment):
    """Both packages' scene, TBL, occluders and one batch of texels with
    the JAX baker's own uniforms (built once for both cases)."""
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
    row_keys = jax.vmap(
        lambda i: jax.random.fold_in(jax.random.PRNGKey(SEED), i)
    )(jnp.asarray(ids))
    samples = np.array(stratified_samples(
        jax.random.PRNGKey(SEED), TEXELS, SPP, "hammersley", row_keys))
    # the azimuth chunk mode's draws: the same shifts on the u2-sorted table
    samples_az = np.array(stratified_samples(
        jax.random.PRNGKey(SEED), TEXELS, SPP, "hammersley", row_keys,
        base=hammersley_azimuth_sorted(SPP)))
    return dict(
        bvh=bvh, jc=jc, jo=jo, jt=jt, pts=pts, nrm=nrm, ids=ids,
        samples=samples, samples_az=samples_az,
        tc=convert.cluster_scene_from_numpy(
            np.asarray(jc.rows3), np.asarray(jc.prims3),
            np.asarray(jc.cluster_lo), np.asarray(jc.cluster_hi),
            float(jc.diameter), jc.lb, jc.has_uv, device="cpu"),
        tt=convert.tbl_from_numpy(np.asarray(jt.uv_u), np.asarray(jt.uv_v),
                                  [np.asarray(p) for p in jt.planes],
                                  device="cpu"),
        to=convert.occluders_from_numpy(
            jo.axis, np.asarray(jo.p), np.asarray(jo.rect_lo),
            np.asarray(jo.rect_hi), float(jo.sep_margin), device="cpu"),
    )


@pytest.mark.parametrize("supersample", [2, 0])
def test_bake_batch_matches_jax(bake_setup, supersample):
    # supersample 2: the prefiltered 1-fetch atlas (the default);
    # 0: the exact 4-fetch bilinear atlas
    s = bake_setup
    jc, jo, jt, tc, tt, to = (s[k] for k in ("jc", "jo", "jt", "tc", "tt",
                                              "to"))
    pts, nrm, ids, samples = s["pts"], s["nrm"], s["ids"], s["samples"]
    jb = JBaker(jt, spp=SPP, texel_batch=TEXELS, cluster_scene=jc, wedges=4,
                pallas_interpret=True)
    # the JAX baker walks blocks of one exit group (fan_block 16): the same
    # groups and hits as blocks of two, and half the interpret-mode program
    jb.fan_block, jb.exit_rows, jb.occluders = 16, 16, jo
    jb.rgbe_supersample = supersample
    ref = np.asarray(jb.bake_batch(jnp.asarray(pts), jnp.asarray(nrm),
                                   jnp.asarray(ids), jnp.int32(SEED)))

    tb = TBaker(tt, spp=SPP, texel_batch=TEXELS, cluster_scene=tc, wedges=4)
    tb.fan_block, tb.exit_rows, tb.occluders = 32, 16, to
    tb.rgbe_supersample = supersample
    got = tb.bake_batch(torch.from_numpy(pts), torch.from_numpy(nrm),
                        torch.from_numpy(ids), SEED,
                        samples=torch.from_numpy(samples)).numpy()
    assert ref.shape == got.shape == (TEXELS, 3)
    assert ref.mean() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _port_baker(s, chunk_mode, spp=SPP, cls=TBaker):
    """The port's baker at the fixture's bake settings (fb 32, er 16,
    occluders, the 1-fetch atlas)."""
    tb = cls(s["tt"], spp=spp, texel_batch=TEXELS, cluster_scene=s["tc"],
             wedges=4)
    tb.fan_block, tb.exit_rows, tb.occluders = 32, 16, s["to"]
    tb.chunk_mode = chunk_mode
    return tb


def _batch(s):
    return (torch.from_numpy(s["pts"]), torch.from_numpy(s["nrm"]),
            torch.from_numpy(s["ids"]))


def test_bake_batch_azimuth_matches_jax(bake_setup):
    """chunk_mode "azimuth": the fans drawn from the u2-sorted Hammersley
    table and wedged unsorted; the port fed the JAX baker's own azimuth
    draws (one interpret-mode compile of the JAX bake)."""
    s = bake_setup
    jb = JBaker(s["jt"], spp=SPP, texel_batch=TEXELS, cluster_scene=s["jc"],
                wedges=4, pallas_interpret=True)
    jb.fan_block, jb.exit_rows, jb.occluders = 16, 16, s["jo"]
    jb.chunk_mode = "azimuth"
    ref = np.asarray(jb.bake_batch(jnp.asarray(s["pts"]),
                                   jnp.asarray(s["nrm"]),
                                   jnp.asarray(s["ids"]), jnp.int32(SEED)))
    got = _port_baker(s, "azimuth").bake_batch(
        *_batch(s), SEED, samples=torch.from_numpy(s["samples_az"])).numpy()
    assert ref.shape == got.shape == (TEXELS, 3)
    assert ref.mean() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_bake_batch_azimuth_equals_octant(bake_setup):
    """The two chunk modes trace the same direction set of each texel (the
    same shift on the same Hammersley points, in another order), so the
    texels agree up to fp32 summation order; the wedge rows differ."""
    s = bake_setup
    az = _port_baker(s, "azimuth").bake_batch(*_batch(s), SEED)
    oc = _port_baker(s, "octant").bake_batch(*_batch(s), SEED)
    assert float(oc.mean()) > 0.1 and not torch.equal(az, oc)
    np.testing.assert_allclose(az.numpy(), oc.numpy(), rtol=1e-5, atol=1e-6)


def test_sharded_azimuth_bake_equals_plain(bake_setup, apartment):
    """ShardedIrradianceBaker honours chunk_mode: over the world's one rank
    its azimuth bake of a 16² atlas equals the plain baker's bit for bit."""
    from texir_code_tpu_torch.parallel.bake import ShardedIrradianceBaker

    s = bake_setup
    geom = t_geometry(apartment.mesh, 16)
    texs = []
    for cls in (TBaker, ShardedIrradianceBaker):
        tb = _port_baker(s, "azimuth", spp=128, cls=cls)
        assert tb.mesh.size == 1
        texs.append(tb.bake(geom, seed_everything(3)))
    assert texs[0][geom.valid].mean() > 0.1
    np.testing.assert_array_equal(texs[0], texs[1])


def test_bake_batch_without_uv_rows_matches_jax(bake_setup):
    """Cluster rows without uv columns (a FanScene built without triangle
    uvs): the walk emits prim + barycentrics and radiance comes from a
    per-corner uv lerp and one exact bilinear RGBE fetch
    (`_fan_estimate_prim_rgbe`).  The port builds its own scene from the
    same BVH; 16 texels of the batch, JAX's own uniforms."""
    s, n = bake_setup, 16
    jb = JBaker(s["jt"], spp=SPP, texel_batch=n, wedges=4,
                cluster_scene=ClusterScene.from_fan(
                    FanScene.from_flat(s["bvh"]), lb=4, dense=True),
                pallas_interpret=True)
    jb.fan_block, jb.exit_rows = 16, 16
    assert not jb.cluster_scene.has_uv
    ref = np.asarray(jb.bake_batch(jnp.asarray(s["pts"][:n]),
                                   jnp.asarray(s["nrm"][:n]),
                                   jnp.asarray(s["ids"][:n]),
                                   jnp.int32(SEED)))

    fb = s["bvh"]
    tfb = FlatBVH(**{f: getattr(fb, f) for f in (
        "aabb_min", "aabb_max", "miss", "leaf_start", "leaf_count", "tri_p0",
        "tri_e1", "tri_e2", "tri_prim", "leaf_width")})
    tc = TC.ClusterScene.from_fan(TF.FanScene.from_flat(tfb), lb=4,
                                  dense=True, device="cpu")
    assert not tc.has_uv
    tb = TBaker(s["tt"], spp=SPP, texel_batch=n, cluster_scene=tc, wedges=4)
    tb.fan_block, tb.exit_rows = 32, 16
    got = tb.bake_batch(torch.from_numpy(s["pts"][:n]),
                        torch.from_numpy(s["nrm"][:n]),
                        torch.from_numpy(s["ids"][:n]), SEED,
                        samples=torch.from_numpy(s["samples"][:n])).numpy()
    assert ref.shape == got.shape == (n, 3)
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
        # one batch of the atlas's ~300 valid texels, not 4096 with padding
        "--set", "train.texel_batch=512",
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


_HEAD_NAMES = {
    # the JAX CLI's head stage names (texir_code_tpu/cli.py:104-144)
    "MatInv": "invrender", "Inv": "invrender", "MatNeilf": "neilf",
    "Neilf": "neilf", "MatRec": "recmlp", "RecMLP": "recmlp",
    "MatInvSyn": "invrender", "InvSyn": "invrender",
    "MatNeilfSyn": "neilf", "NeilfSyn": "neilf", "MatRecSyn": "recmlp",
    "RecMLPSyn": "recmlp",
}


def _reached_runner(monkeypatch, name):
    """The (runner class, head) `train --trainstage name` builds, with the
    runners replaced by recorders."""
    from texir_code_tpu_torch.train import heads

    seen = []

    def recorder(cls_name):
        def make(conf, head, **kw):
            seen.append((cls_name, head, kw["device"]))
            return type("Run", (), {"run": lambda self: None})()
        return make

    for cls_name in ("BaselineHeadRunner", "BaselineHeadSynRunner"):
        monkeypatch.setattr(heads, cls_name, recorder(cls_name))
    assert cli.main(["train", "--conf", _conf(), "--trainstage", name,
                     "--device", "cpu"]) == 0
    return seen


def test_cli_unported_stage_names_roadmap(monkeypatch):
    """The heads were the last stages the port's CLI refused: MatInv now
    reaches its runner instead of the ROADMAP's "not ported" exit."""
    assert _reached_runner(monkeypatch, "MatInv") == [
        ("BaselineHeadRunner", "invrender", "cpu")]
    with pytest.raises(SystemExit, match="unknown train stage"):
        cli.main(["train", "--conf", _conf(), "--trainstage", "MatFoo"])


@pytest.mark.parametrize("name", sorted(_HEAD_NAMES))
def test_cli_head_stage_names_reach_their_runner(monkeypatch, name):
    cls = "BaselineHeadSynRunner" if name.endswith("Syn") else \
        "BaselineHeadRunner"
    assert _reached_runner(monkeypatch, name) == [
        (cls, _HEAD_NAMES[name], "cpu")]


def test_runner_unported_knob_raises(apartment, tmp_path):
    """train.spmd=true in one process: the baker's batches split over the
    world's one rank, whose raw bake equals the unsharded baker's bit for
    bit."""
    from texir_code_tpu_torch.train.irt import IrrTextureRunner
    from texir_code_tpu_torch.config import _parse_value, parse_file

    path = _write_scene(apartment, str(tmp_path))
    raws = []
    for spmd in ("true", "false"):
        conf = parse_file(_conf())
        for kv in (f"train.path_mesh_open3d={path}",
                   "train.sample_light=[64, 16]", "train.texel_batch=128",
                   f"train.spmd={spmd}"):
            k, _, v = kv.partition("=")
            conf.put(k, _parse_value(v))
        runner = IrrTextureRunner(conf, exps_root=str(tmp_path / "exps"),
                                  texture_res=16, denoise=False,
                                  device="cpu")
        assert runner.baker.mesh.size == 1
        runner.run()
        raws.append(hdrio.read_hdr(
            path.replace("out1.obj", "0_irr_texture.hdr"), flip=True))
    assert raws[0].any()
    np.testing.assert_array_equal(raws[0], raws[1])


def test_seed_everything_returns_generator():
    a = seed_everything(666)
    b = seed_everything(666)
    assert isinstance(a, torch.Generator)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
