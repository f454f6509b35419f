"""Port vs JAX: the culled cluster walk (kernel B1's plain version) and its
culling, at the bake shape (fan_block 32, exit_rows 16, lb 4, 4 wedges).

The JAX side runs `cast_fans_culled(..., interpret=True)`, whose reciprocal
is IEEE `1/nd`.  Both packages trace the same packed scene (convert.py) and
the same rays (numpy from a seed), so:
  * cull lists (cand/count/dist) are equal exactly;
  * t, u, v agree within 1e-5 (XLA may contract a multiply-add in the
    barycentric terms, the port rounds each product; measured ~1e-6);
  * prim is exact except on t-ties (two triangles at the same t).
The brute-force oracle (Möller–Trumbore over every triangle) computes t by
another formula, so it is held to 1e-4.
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
from texir_code_tpu.ops.raycast import cast_rays_brute as j_brute
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.ops import pallas_culled as T
from texir_code_tpu_torch.ops.raycast import cast_rays_brute as t_brute

FAN_BLOCK, EXIT_ROWS, WEDGES = 32, 16, 4
TEXELS, SPP = 60, 512  # 240 wedge rows: not a multiple of fan_block (padding)


@pytest.fixture(scope="module")
def setup():
    syn = make_apartment_scene(atlas_res=64, subdiv=6)
    bvh = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(bvh, triangle_uvs=syn.mesh.triangle_uvs())
    jc = J.ClusterScene.from_fan(fan, lb=4, dense=True)
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
    rng = np.random.default_rng(5)
    sx, sy, sz = syn.size
    # texels come in spatially tight runs of 16, like the bake's
    # Morton-ordered batches (each exit group then has a small origin box)
    centers = np.stack([rng.uniform(0.5, sx - 0.5, TEXELS // 16 + 1),
                        rng.uniform(0.5, sy - 0.5, TEXELS // 16 + 1),
                        rng.uniform(0.5, sz - 0.5, TEXELS // 16 + 1)], -1)
    pts = (np.repeat(centers, 16, axis=0)[:TEXELS]
           + rng.uniform(-0.1, 0.1, (TEXELS, 3))).astype(np.float32)
    # uniform directions over the sphere, octant-sorted and wedged as the
    # bake does (sorting is tested against JAX in test_torch_sampling_tbl)
    d = rng.standard_normal((TEXELS, SPP, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ds = J.sort_dirs_octant(tuple(jnp.asarray(d[..., k]) for k in range(3)))
    rows_d = tuple(np.asarray(J.wedge_rows(a, WEDGES)) for a in ds)
    rows_o = tuple(np.tile(pts[:, k], WEDGES) for k in range(3))
    return dict(syn=syn, jc=jc, jo=jo, tc=tc, to=to, rows_o=rows_o,
                rows_d=rows_d, jax_hits={})


def _j(x):
    return tuple(jnp.asarray(a) for a in x)


def _t(x):
    return tuple(torch.from_numpy(np.array(a)) for a in x)


def jax_hit(s, emit_uv):
    """JAX interpret-mode hits (cached per mode: they take seconds)."""
    if emit_uv not in s["jax_hits"]:
        h = J.cast_fans_culled(
            s["jc"], _j(s["rows_o"]), _j(s["rows_d"]), fan_block=FAN_BLOCK,
            exit_rows=EXIT_ROWS, emit_uv=emit_uv, interpret=True,
            occluders=s["jo"],
        )
        s["jax_hits"][emit_uv] = [np.asarray(a) for a in (h.t, h.prim, h.u, h.v)]
    return s["jax_hits"][emit_uv]


def port_hit(s, emit_uv, **kw):
    h = T.cast_fans_culled(
        s["tc"], _t(s["rows_o"]), _t(s["rows_d"]), fan_block=FAN_BLOCK,
        exit_rows=EXIT_ROWS, emit_uv=emit_uv, occluders=s["to"], **kw,
    )
    return [a.numpy() for a in (h.t, h.prim, h.u, h.v)]


@pytest.mark.parametrize("occluders", [False, True])
def test_cull_blocks_equal(setup, occluders):
    s = setup
    a = J.cull_blocks(s["jc"], _j(s["rows_o"]), _j(s["rows_o"]),
                      _j(s["rows_d"]), EXIT_ROWS,
                      occluders=s["jo"] if occluders else None)
    b = T.cull_blocks(s["tc"], _t(s["rows_o"]), _t(s["rows_o"]),
                      _t(s["rows_d"]), EXIT_ROWS,
                      occluders=s["to"] if occluders else None)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert int(b[1].sum()) > 0


def test_occluders_cull_something(setup):
    s = setup
    plain = T.cull_blocks(s["tc"], _t(s["rows_o"]), _t(s["rows_o"]),
                          _t(s["rows_d"]), EXIT_ROWS)
    occ = T.cull_blocks(s["tc"], _t(s["rows_o"]), _t(s["rows_o"]),
                        _t(s["rows_d"]), EXIT_ROWS, occluders=s["to"])
    assert int(occ[1].sum()) < int(plain[1].sum())


def _assert_hits_close(ref, got, tol, emit_prim):
    t0, p0, u0, v0 = ref
    t1, p1, u1, v1 = got
    assert t0.shape == t1.shape
    assert np.array_equal(np.isfinite(t0), np.isfinite(t1))
    fin = np.isfinite(t0)
    dt = np.abs(np.where(fin, t0 - t1, 0.0))
    assert dt.max() <= tol
    # on a t-tie another triangle (with its own u, v) may win
    tie = (p0 != p1) if emit_prim else np.zeros_like(fin)
    assert tie.mean() < 1e-3
    assert np.abs(np.where(tie, 0.0, u0 - u1)).max() <= tol
    assert np.abs(np.where(tie, 0.0, v0 - v1)).max() <= tol


@pytest.mark.parametrize("emit_uv", [True, False])
def test_walk_matches_jax_interpret(setup, emit_uv):
    ref = jax_hit(setup, emit_uv)
    got = port_hit(setup, emit_uv)
    assert np.isfinite(ref[0]).mean() > 0.99  # closed apartment
    _assert_hits_close(ref, got, 1e-5, emit_prim=not emit_uv)
    if emit_uv:
        assert (got[1] == -1).all()  # emit_prim defaults to not emit_uv


def test_walk_matches_brute_force(setup):
    s = setup
    mesh = s["syn"].mesh
    o = np.stack([np.repeat(a, SPP // WEDGES) for a in s["rows_o"]], -1)
    d = np.stack([a.reshape(-1) for a in s["rows_d"]], -1)
    tb = t_brute(torch.from_numpy(mesh.vertices), torch.from_numpy(mesh.faces),
                 torch.from_numpy(o), torch.from_numpy(d), chunk=4096)
    ref = [a.numpy().reshape(s["rows_d"][0].shape) for a in
           (tb.t, tb.prim, tb.u, tb.v)]
    got = port_hit(s, False)
    jax = jax_hit(s, False)
    for hits in (got, jax):
        fin = np.isfinite(ref[0])
        assert np.array_equal(fin, np.isfinite(hits[0]))
        dt = np.abs(np.where(fin, ref[0] - hits[0], 0.0))
        assert dt.max() <= 1e-4
        # a different prim is allowed only where the t's agree (a tie)
        assert ((hits[1] != ref[1]) & (dt > 1e-4)).sum() == 0
        assert (hits[1] != ref[1]).mean() < 1e-3


def test_brute_force_matches_jax(setup):
    mesh = setup["syn"].mesh
    rng = np.random.default_rng(9)
    o = np.tile(np.asarray(setup["syn"].size, np.float32) / 2, (300, 1))
    d = rng.standard_normal((300, 3)).astype(np.float32)
    a = j_brute(jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces),
                jnp.asarray(o), jnp.asarray(d), chunk=256)
    b = t_brute(torch.from_numpy(mesh.vertices), torch.from_numpy(mesh.faces),
                torch.from_numpy(o), torch.from_numpy(d), chunk=256)
    assert np.array_equal(np.asarray(a.prim), b.prim.numpy())
    np.testing.assert_allclose(np.asarray(a.t), b.t.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(a.u), b.u.numpy(), atol=1e-6)


def test_t_cap_truncates(setup):
    s = setup
    full = port_hit(s, False)
    cut = port_hit(s, False, t_cap_frac=0.3)
    cap = 0.3 * s["tc"].diameter
    near = full[0] <= cap * 0.9
    # hits well inside the cap are exact; the walk stopped early elsewhere
    assert near.any()
    assert np.array_equal(cut[0][near], full[0][near])


@pytest.mark.parametrize("kw", [dict(seed="seed"), dict(debug_emit_visits=True)])
def test_unported_modes_raise(setup, kw):
    if "seed" in kw:  # any seed hit record selects the seeded walk
        kw = dict(seed=port_hit(setup, False))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_hit(setup, False, **kw)


def test_cpu_walk_launches_no_kernel(setup):
    before = dict(T.culled_walk_cuda.launches)
    port_hit(setup, True, stream_cands=1024)
    assert T.culled_walk_cuda.launches == before
