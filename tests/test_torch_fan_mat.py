"""Port vs JAX: kernel B3 (the exhaustive leaf stream with per-ray origins,
`ops/pallas_fan.py::cast_rays_pallas_stream`) and the Mat model without
its ClusterScene, whose G-buffer (B2) and specular trace (B3) run the
stream (`models/material.py` with `model.cluster_scene = None`).

The scene is the JAX tests' small apartment (`make_apartment_scene(
atlas_res=64, subdiv=6)`, 151 leaf rows); the Mat model renders one camera
at pano 16×32 (cube faces of 8²) with 4 specular rays a pixel and 32²
atlases.  On the JAX side `pallas_fan.FORCE_INTERPRET` is set (the Pallas
dispatch in interpret mode, as tests/test_material.py does) and its two
stream entry points run at leaf block 2: the leaf block changes no
output, and JAX interpret mode compiles for minutes at the dispatch
sites' 16 and 32.

Tolerances: B3 hits as in test_torch_fan.py (t bit-equal, u/v within
1e-5, prim equal but on exact-t ties, at most 1e-2 of the rays; t within
1e-4 relative of the brute-force oracle).  The Mat step: loss within
1e-5 relative, gradients within rtol 1e-4 (atol 1e-6) — the limits of the
port's Mat tests; both packages fetch radiance from the prefiltered
atlas at the kernel's interpolated uv.  `shade_chunk` renders the same
image as the one-shot forward (bit-equal: every pixel's work is its
own).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.synthetic import make_apartment_scene
from texir_code_tpu.geometry.bvh import build_bvh
from texir_code_tpu.models import losses as JL
from texir_code_tpu.models.material import MaterialModel as JMat
from texir_code_tpu.models.material import MaterialParams as JParams
from texir_code_tpu.ops import gbuffer as JG
from texir_code_tpu.ops import pallas_fan as JF
from texir_code_tpu.ops.fan_raycast import FanScene
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.models import losses as TL
from texir_code_tpu_torch.models.material import MaterialModel as TMat
from texir_code_tpu_torch.ops import pallas_fan as TF
from texir_code_tpu_torch.ops.chunking import map_chunked
from texir_code_tpu_torch.ops.fan_raycast import FanScene as TFan
from texir_code_tpu_torch.ops.raycast import cast_rays_brute

torch.set_num_threads(2)  # six test workers share the host's cores

LB = 2                    # the JAX kernels' leaf block in these tests
ROWS, R = 10, 128         # per-ray rows (no multiple of the fan block)
UV_TOL, TIE_FRAC = 1e-5, 1e-2
PANO, SPEC_SPP, NUM_CLASSES = (16, 32), 4, 5


def _leaf_block(fn):
    """A JAX dispatch function that runs at leaf block LB."""
    @functools.wraps(fn)
    def call(*args, **kw):
        kw["leaf_block"] = LB
        return fn(*args, **kw)
    return call


@pytest.fixture(scope="module")
def setup():
    syn = make_apartment_scene(atlas_res=64, subdiv=6)
    fan = FanScene.from_flat(build_bvh(syn.mesh.vertices, syn.mesh.faces),
                             triangle_uvs=syn.mesh.triangle_uvs())
    with pytest.MonkeyPatch.context() as mp:
        for name in ("cast_ray_fans_pallas", "cast_rays_pallas_stream"):
            mp.setattr(JF, name, _leaf_block(getattr(JF, name)))
        mp.setattr(JF, "FORCE_INTERPRET", True)
        yield dict(syn=syn, fan=fan,
                   tfan=TFan(rows=np.array(fan.rows), diameter=fan.diameter))


def _np(h):
    return [np.asarray(a) for a in (h.t, h.prim, h.u, h.v)]


def _agree(got, ref):
    t, prim, u, v = got
    assert np.array_equal(t, ref[0])
    tie = prim != ref[1]
    assert tie.mean() <= TIE_FRAC
    assert np.isfinite(ref[0][tie]).all()
    assert np.abs(u - ref[2])[~tie].max() <= UV_TOL
    assert np.abs(v - ref[3])[~tie].max() <= UV_TOL


@pytest.mark.parametrize("emit_uv", [True, False])
def test_per_ray_matches_jax(setup, emit_uv):
    """B3 on 10 rows of 128 rays with their own origins (t_min 0): the
    emit_uv mode (the prefiltered specular fetch) and the prim mode (the
    exact fetch)."""
    s = setup
    rng = np.random.default_rng(31 + emit_uv)
    lo, hi = np.array([0.5, 0.3, 0.5]), np.array(s["syn"].size) - 0.5
    o = rng.uniform(lo, hi, (ROWS, R, 3)).astype(np.float32)
    d = rng.standard_normal((ROWS, R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    oj = tuple(np.ascontiguousarray(o[..., k]) for k in range(3))
    dj = tuple(np.ascontiguousarray(d[..., k]) for k in range(3))
    ref = _np(JF.cast_rays_pallas_stream(
        s["fan"], tuple(map(jnp.asarray, oj)), tuple(map(jnp.asarray, dj)),
        emit_uv=emit_uv, interpret=True))
    h = TF.cast_rays_pallas_stream(
        s["tfan"], tuple(map(torch.from_numpy, oj)),
        tuple(map(torch.from_numpy, dj)), emit_uv=emit_uv)
    got = [a.numpy() for a in (h.t, h.prim, h.u, h.v)]
    _agree(got, ref)
    assert np.isfinite(got[0]).mean() > 0.99
    m = s["syn"].mesh
    bf = cast_rays_brute(
        torch.from_numpy(m.vertices.astype(np.float32)),
        torch.from_numpy(m.faces.astype(np.int32)),
        torch.from_numpy(o.reshape(-1, 3)), torch.from_numpy(d.reshape(-1, 3)))
    np.testing.assert_allclose(got[0].reshape(-1), bf.t.numpy(), rtol=1e-4)
    assert (got[1].reshape(-1) != bf.prim.numpy()).mean() <= TIE_FRAC


# ---------------------------------------------------------------------------
# the Mat model without its ClusterScene
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mat(setup):
    s = setup
    syn = s["syn"]
    m = syn.mesh
    rng = np.random.default_rng(41)
    irt = rng.uniform(0.5, 2.0, (32, 32, 3)).astype(np.float32)
    jm = JMat(m, syn.hdr_texture, irt, pano_res=PANO,
              sample_light=(32, SPEC_SPP))
    assert jm.use_pallas  # FORCE_INTERPRET: the Pallas dispatch
    jm.cluster_scene = None
    tmesh = convert.mesh_from_numpy(m.vertices, m.faces, m.uvs, m.uv_faces,
                                    m.vertex_normals)
    tm = TMat(tmesh, syn.hdr_texture, irt, pano_res=PANO,
              sample_light=(32, SPEC_SPP), device="cpu")
    tm.cluster_scene = None
    pos = syn.camera_positions(1)[0]
    ext = np.eye(4, dtype=np.float32)
    ext[0:3, 3] = pos
    mvp = np.array(JG.cube_mvp(jnp.asarray(ext)))
    res = jm.cube_res
    b = 6 * res * res
    key = jax.random.PRNGKey(9)
    # the JAX model's own draw (models/material.py:585-597)
    rows = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(b, dtype=jnp.int32))
    shift = np.array(jax.vmap(lambda k: jax.random.uniform(k, (2,)))(rows))
    ones = np.ones((6, res, res, 1), np.float32)
    return dict(
        jm=jm, tm=tm, mvp=mvp, pos=pos, key=key, shift=shift,
        albedo=rng.uniform(0.2, 0.8, (32, 32, 3)).astype(np.float32),
        rough=rng.uniform(0.1, 0.6, (32, 32, 1)).astype(np.float32),
        loss_kw=dict(
            gt_img=rng.uniform(0.0, 1.5, (6, res, res, 3)).astype(np.float32),
            gt_mask=ones, seg_id=rng.integers(0, NUM_CLASSES - 1,
                                              (6, res, res)).astype(np.int32),
            num_classes=NUM_CLASSES, stage=2,
            highlight=(rng.random((6, res, res, 1)) < 0.3).astype(np.float32),
            seg_region=ones,
            room_id=rng.integers(0, 2, (6, res, res)).astype(np.int32),
            num_rooms=2),
    )


def _loss(lib, out, kw):
    conv = jnp.asarray if lib is JL else torch.from_numpy
    kw = {k: conv(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    return lib.render_loss(kw.pop("gt_img"), out, **kw)[0]


def test_fan_mat_stage2_loss_and_gradients_match_jax(mat):
    s = mat

    def jloss(p):
        out = s["jm"]._forward(p, jnp.asarray(s["mvp"]), jnp.asarray(s["pos"]),
                               s["key"], stage=2)
        return _loss(JL, out, dict(s["loss_kw"]))

    lj, gj = jax.jit(jax.value_and_grad(jloss))(
        JParams(jnp.asarray(s["albedo"]), jnp.asarray(s["rough"])))
    p = convert.material_params_from_numpy(s["albedo"], s["rough"],
                                           device="cpu", requires_grad=True)
    before = dict(TF.fan_stream_cuda.launches)
    out = s["tm"]._forward(p, s["mvp"], s["pos"], 2, spec_shift=s["shift"])
    assert TF.fan_stream_cuda.launches == before  # CPU: the plain stream
    lt = _loss(TL, out, dict(s["loss_kw"]))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for name in ("albedo", "roughness"):
        a = np.asarray(getattr(gj, name))
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(getattr(p, name).grad.numpy(), a,
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_fan_mat_shade_chunk_equals_one_shot(mat):
    """shade_chunk (models/material.py, the eval renderer's pixel chunks)
    renders the same image as the one-shot forward: 384 pixels in chunks
    of 100 (the last one padded)."""
    s = mat
    tm = s["tm"]
    p = convert.material_params_from_numpy(s["albedo"], s["rough"],
                                           device="cpu")
    one = tm._forward(p, s["mvp"], s["pos"], 2, spec_shift=s["shift"])
    tm.shade_chunk = 100
    try:
        chunked = tm._forward(p, s["mvp"], s["pos"], 2, spec_shift=s["shift"])
    finally:
        tm.shade_chunk = None
    for k in ("rgb", "albedo", "roughness", "roughness_womipmap"):
        assert torch.equal(one[k], chunked[k]), k
    assert one["rgb"].max() > 0


def test_map_chunked_pads_and_concatenates():
    from texir_code_tpu.ops.chunking import map_chunked as j_map_chunked

    rng = np.random.default_rng(3)
    x = rng.standard_normal((10, 3)).astype(np.float32)
    y = rng.standard_normal((10,)).astype(np.float32)

    def fn(a):
        return (a[0] * a[1][:, None], a[1] + 1.0)

    ref = j_map_chunked(fn, (jnp.asarray(x), jnp.asarray(y)), 4)
    got = map_chunked(fn, (torch.from_numpy(x), torch.from_numpy(y)), 4)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
