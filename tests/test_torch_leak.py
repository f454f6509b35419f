"""Rays that leak through a triangle edge, on the bench building
(`make_building_scene(atlas_res=256, subdiv=28)`, 104,076 triangles,
cluster size 4, its 46 proven occluders).

The culled walk's plane-dual triangle test can reject both triangles of a
shared edge, so a ray through that edge passes the surface.  What it hits
next depends on its exit group's candidate list: a proven occluder drops
the clusters behind it when every origin of the group lies in front.  So
the two-pass trace, whose pass-2 groups hold other rays, can give such a
ray a hit where the single pass gives none.  The rays below are the four
of one building bake batch whose t differed between the two passes on the
card (`chip_smoke.py`, [building-kernels]); their origins and directions
are the batch's float32 values.  These tests hold that the JAX package's
single pass walks them the same way: it misses the first one with the
occluders and hits the floor behind the box without them, bit for bit as
the port does, while the exact brute-force trace hits the box.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.synthetic import make_building_scene
from texir_code_tpu.geometry.bvh import build_bvh
from texir_code_tpu.geometry.occluders import extract_occluders
from texir_code_tpu.ops import pallas_culled as J
from texir_code_tpu.ops.fan_raycast import FanScene
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.ops import pallas_culled as T
from texir_code_tpu_torch.ops.raycast import cast_rays_brute

torch.set_num_threads(2)  # six test workers share the host's cores

R = 128
UV_TOL = 1e-6
# (origin, direction) of each leaking ray, float32 as hex
RAYS = [
    (("0x1.7d8e96p+3", "0x1.03fbdap+0", "0x1.609cacp+3"),
     ("0x1.1afd8cp-1", "-0x1.8e8694p-1", "-0x1.30e006p-2")),
    (("0x1.7fb1a4p+3", "0x1.03fbdap+0", "0x1.606ee0p+3"),
     ("0x1.85ba7ep-4", "-0x1.8eabe8p-4", "-0x1.fb3c06p-1")),
    (("0x1.7c2ca0p+3", "0x1.03fbdap+0", "0x1.5f6b5cp+3"),
     ("-0x1.c1eb58p-2", "-0x1.013122p-1", "0x1.7d4c8ep-1")),
    (("0x1.819452p+3", "0x1.03fbdap+0", "0x1.5f4cd4p+3"),
     ("-0x1.b53d3cp-1", "-0x1.1ea45ep-2", "0x1.c11b9cp-2")),
]
# the first ray's hit without occluders: the floor behind the box, the
# hit the two-pass trace found on the card
FLOOR_T = 1.3047280311584473


def _ray(i):
    o, d = (np.float32([float.fromhex(x) for x in v]) for v in RAYS[i])
    return o, d


@pytest.fixture(scope="module")
def setup():
    syn = make_building_scene(atlas_res=256, subdiv=28)
    bvh = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(bvh, triangle_uvs=syn.mesh.triangle_uvs())
    jc = J.ClusterScene.from_fan(fan, lb=4, dense=True)
    jo = extract_occluders(syn.mesh)
    tc = convert.cluster_scene_from_numpy(
        np.asarray(jc.rows3), np.asarray(jc.prims3), np.asarray(jc.cluster_lo),
        np.asarray(jc.cluster_hi), float(jc.diameter), jc.lb, jc.has_uv,
        device="cpu")
    to = convert.occluders_from_numpy(
        jo.axis, np.asarray(jo.p), np.asarray(jo.rect_lo),
        np.asarray(jo.rect_hi), float(jo.sep_margin), device="cpu")
    return dict(syn=syn, jc=jc, jo=jo, tc=tc, to=to)


def _row(i):
    """One bake-layout row: the ray's origin, R copies of its direction."""
    o, d = _ray(i)
    return (tuple(np.full((1,), o[k], np.float32) for k in range(3)),
            tuple(np.full((1, R), d[k], np.float32) for k in range(3)))


def _port(s, i, occluders):
    o, d = _row(i)
    h = T.cast_fans_culled(
        s["tc"], tuple(map(torch.from_numpy, o)),
        tuple(map(torch.from_numpy, d)), fan_block=1, emit_uv=True,
        occluders=s["to"] if occluders else None)
    return [np.array(a) for a in (h.t, h.prim, h.u, h.v)]


def _brute(s, i):
    o, d = _ray(i)
    m = s["syn"].mesh
    h = cast_rays_brute(torch.from_numpy(m.vertices), torch.from_numpy(m.faces),
                        torch.from_numpy(o[None]), torch.from_numpy(d[None]))
    return float(h.t[0]), int(h.prim[0])


@pytest.mark.parametrize("occluders", [True, False])
def test_jax_single_pass_leaks_as_the_port_does(setup, occluders):
    o, d = _row(0)
    oj, dj = tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d))
    # the lists JAX's cast_fans_culled makes for this row (one row, one
    # group), computed apart: both occluder settings run one compiled
    # JAX kernel
    cull = J.cull_blocks(setup["jc"], oj, oj, dj, 1,
                         occluders=setup["jo"] if occluders else None)
    h = J.cast_fans_culled(setup["jc"], oj, dj, fan_block=1, emit_uv=True,
                           interpret=True, cull=cull)
    ref = [np.asarray(a) for a in (h.t, h.prim, h.u, h.v)]
    # the lists handed to JAX are the ones the port's walk makes
    wa = T.walk_args(setup["tc"], tuple(map(torch.from_numpy, o)),
                     tuple(map(torch.from_numpy, d)), fan_block=1,
                     emit_uv=True,
                     occluders=setup["to"] if occluders else None)
    for name, a in zip(("cand", "count", "dist"), cull):
        b = wa[name].numpy()
        assert np.array_equal(np.asarray(a).reshape(b.shape), b), name
    got = _port(setup, 0, occluders)
    # t and prim bit-equal; u and v within UV_TOL (XLA contracts a
    # multiply-add in the barycentric terms, the port rounds each product)
    for a, b in zip(got[:2], ref[:2]):
        assert np.array_equal(a, b)
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=UV_TOL)
    assert (ref[0] == (np.inf if occluders else np.float32(FLOOR_T))).all()
    t, prim = _brute(setup, 0)
    assert 0 < t < FLOOR_T and prim >= 0


@pytest.mark.parametrize("i", range(len(RAYS)))
def test_logged_rays_leak_through_the_box(setup, i):
    """Each logged ray misses in the port's single pass with the occluders
    and hits the floor or a far wall without them, while the exact trace
    hits the box it leaves from, nearer than either."""
    t_brute, _ = _brute(setup, i)
    t_occ = _port(setup, i, True)[0]
    t_free = _port(setup, i, False)[0]
    assert (t_occ == np.inf).all()
    assert np.isfinite(t_free).all() and (t_free > t_brute).all()
