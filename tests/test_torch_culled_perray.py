"""Port vs JAX: kernel B1's plain version in the two shapes of the Mat step,
both at cluster size lb 8.

  * specular (shape c): per-ray origins, exit_rows 1, fan_block 8, emit_uv;
  * G-buffer (shape b): one shared origin, one exit group per 8-row block,
    emit_prim, t_min 1e-6.

The JAX side runs `cast_fans_culled(..., interpret=True)` (IEEE `1/nd`).
Both trace the same packed scene and rays (numpy from a seed), with
proven occluders on and off.  Tolerances: t/u/v within 1e-6 absolute (the
port rounds each product in the reference's order; XLA may contract one,
measured below 1e-6), prim exact except where two triangles tie in t.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.synthetic import make_apartment_scene
from texir_code_tpu.geometry.bvh import build_bvh
from texir_code_tpu.geometry.occluders import extract_occluders
from texir_code_tpu.ops import pallas_culled as J
from texir_code_tpu.ops.fan_raycast import FanScene
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.ops import pallas_culled as T

LB = 8
R = 128
# neither row count is a multiple of fan_block 8 (padding); the specular
# rows are few because JAX's interpret mode walks each of them on its own
SPEC_ROWS, GBUF_ROWS = 7, 20
TOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    syn = make_apartment_scene(atlas_res=64, subdiv=6)
    bvh = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(bvh, triangle_uvs=syn.mesh.triangle_uvs())
    jc = J.ClusterScene.from_fan(fan, lb=LB, dense=True)
    jo = extract_occluders(syn.mesh)
    tc = convert.cluster_scene_from_numpy(
        np.asarray(jc.rows3), np.asarray(jc.prims3),
        np.asarray(jc.cluster_lo), np.asarray(jc.cluster_hi),
        float(jc.diameter), jc.lb, jc.has_uv, device="cpu",
    )
    to = convert.occluders_from_numpy(
        jo.axis, np.asarray(jo.p), np.asarray(jo.rect_lo),
        np.asarray(jo.rect_hi), float(jo.sep_margin), device="cpu",
    )
    rng = np.random.default_rng(11)
    size = np.asarray(syn.size, np.float32)
    # specular rows: the points of R raster-consecutive pixels lie close
    # together, each ray leaves from its own point
    centers = rng.uniform(0.3, 1.0, (SPEC_ROWS, 3)) * (size - 0.6) + 0.3
    o_spec = (centers[:, None, :] + rng.uniform(
        -0.05, 0.05, (SPEC_ROWS, R, 3))).astype(np.float32)
    d = rng.standard_normal((SPEC_ROWS, R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # G-buffer rows: one camera, pixel directions of a coherent cone
    cam = (size / 2).astype(np.float32)
    axis = rng.standard_normal((GBUF_ROWS, 1, 3))
    dg = (axis + 0.3 * rng.standard_normal((GBUF_ROWS, R, 3))).astype(
        np.float32)
    dg /= np.linalg.norm(dg, axis=-1, keepdims=True)
    return dict(
        jc=jc, jo=jo, tc=tc, to=to,
        spec_o=tuple(o_spec[..., k] for k in range(3)),
        spec_d=tuple(d[..., k] for k in range(3)),
        gbuf_o=tuple(np.full(GBUF_ROWS, cam[k], np.float32)
                     for k in range(3)),
        gbuf_d=tuple(dg[..., k] for k in range(3)),
    )


SHAPES = {
    "specular": dict(per_ray=True, fan_block=8, exit_rows=1, emit_uv=True),
    "gbuffer": dict(fan_block=8, exit_rows=0, emit_prim=True, t_min=1e-6),
}


def _hits(s, shape, occluders):
    kw = SHAPES[shape]
    key = "spec" if shape == "specular" else "gbuf"
    o, d = s[f"{key}_o"], s[f"{key}_d"]
    # with exit_rows 1 every row is its own exit group with its own list,
    # whatever the block: JAX runs blocks of one row, whose interpret-mode
    # program (one group) compiles ~8x faster than a block of eight
    jkw = dict(kw, fan_block=1) if kw.get("exit_rows") == 1 else kw
    hj = J.cast_fans_culled(
        s["jc"], tuple(jnp.asarray(a) for a in o),
        tuple(jnp.asarray(a) for a in d), interpret=True,
        occluders=s["jo"] if occluders else None, **jkw,
    )
    ht = T.cast_fans_culled(
        s["tc"], tuple(torch.from_numpy(a) for a in o),
        tuple(torch.from_numpy(a) for a in d),
        occluders=s["to"] if occluders else None, **kw,
    )
    ref = [np.asarray(a) for a in (hj.t, hj.prim, hj.u, hj.v)]
    got = [a.numpy() for a in (ht.t, ht.prim, ht.u, ht.v)]
    return ref, got


def d_shape(s, shape):
    return (s["spec_d"] if shape == "specular" else s["gbuf_d"])[0].shape


@pytest.mark.parametrize("occluders", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_walk_matches_jax_interpret(setup, shape, occluders):
    ref, got = _hits(setup, shape, occluders)
    t0, p0, u0, v0 = ref
    t1, p1, u1, v1 = got
    assert t1.shape == t0.shape == d_shape(setup, shape)
    assert np.isfinite(t0).mean() > 0.99  # closed apartment
    assert np.array_equal(np.isfinite(t0), np.isfinite(t1))
    fin = np.isfinite(t0)
    assert np.abs(np.where(fin, t0 - t1, 0.0)).max() <= TOL
    tie = p0 != p1  # a t-tie: another triangle at the same t won
    assert tie.mean() < 1e-3
    assert np.abs(np.where(tie, 0.0, u0 - u1)).max() <= TOL
    assert np.abs(np.where(tie, 0.0, v0 - v1)).max() <= TOL
    if shape == "specular":
        assert (p1 == -1).all()  # emit_prim defaults to not emit_uv
    else:
        assert (p1[fin] >= 0).all()


def test_per_ray_cull_uses_row_boxes(setup):
    """Per-ray culling widens each group's origin box to its rows' spread:
    the lists equal JAX's cull_blocks on the per-row min/max."""
    s = setup
    o = s["spec_o"]
    lo = tuple(a.min(axis=1) for a in o)
    hi = tuple(a.max(axis=1) for a in o)
    a = J.cull_blocks(s["jc"], tuple(map(jnp.asarray, lo)),
                      tuple(map(jnp.asarray, hi)),
                      tuple(map(jnp.asarray, s["spec_d"])), 1,
                      occluders=s["jo"])
    b = T.cull_blocks(s["tc"], tuple(map(torch.from_numpy, lo)),
                      tuple(map(torch.from_numpy, hi)),
                      tuple(map(torch.from_numpy, s["spec_d"])), 1,
                      occluders=s["to"])
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())


def test_walk_mode_names():
    assert T.walk_mode(False, True, False) == "shared_uv"
    assert T.walk_mode(False, False, True) == "shared_prim"
    assert T.walk_mode(True, True, False) == "per_ray_uv"
