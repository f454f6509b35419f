"""Port vs JAX: the multi-room building — the scene, the occlusion proxy,
and kernel B1's seeded walk (its plain version) in the three shapes of the
main path with its truncated candidate counts.  (The two-pass trace and the
baker's batch: test_torch_twopass.py; the CLI stages on a building export:
test_torch_building_cli.py.)

The walks run on the JAX tests' small building (`make_building_scene(
atlas_res=32, rooms=(2, 2), subdiv=3, clutter_per_room=1)`), occluders on.
JAX interpret mode compiles each kernel variant for seconds, so there is
one JAX call per mode; the JAX side gets the port's seed as its `seed=`
(the seed is the port's proxy pre-trace, itself the unseeded walk).
Tolerances: the port's seeded hits equal its unseeded and proxy-seeded
hits bit for bit (seeding is exact); against JAX, t and prim are
bit-equal and u, v within 1e-6 (XLA contracts a multiply-add in the
barycentric terms, the port rounds each product as the CUDA kernel does);
candidate counts are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data import synthetic as JS
from texir_code_tpu.geometry.bvh import build_bvh
from texir_code_tpu.geometry.occluders import extract_occluders
from texir_code_tpu.ops import pallas_culled as J
from texir_code_tpu.ops.fan_raycast import FanScene
from texir_code_tpu.ops.raycast import RayHit as JHit
from texir_code_tpu_torch import convert
from texir_code_tpu_torch.data import synthetic as TS
from texir_code_tpu_torch.geometry.bvh import build_bvh as t_build_bvh
from texir_code_tpu_torch.ops import pallas_culled as T
from texir_code_tpu_torch.ops.fan_raycast import FanScene as TFan

torch.set_num_threads(2)  # six test workers share the host's cores

SMALL = dict(atlas_res=32, rooms=(2, 2), subdiv=3, clutter_per_room=1)
ROWS, R = 16, 128
UV_TOL = 1e-6


@pytest.mark.parametrize("size", ["small", "bench"])
def test_building_scene_matches_jax(size):
    kw = SMALL if size == "small" else dict(atlas_res=256, subdiv=28)
    a, b = JS.make_building_scene(**kw), TS.make_building_scene(**kw)
    for k in ("vertices", "faces", "uvs", "uv_faces", "vertex_normals"):
        assert np.array_equal(getattr(a.mesh, k), getattr(b.mesh, k)), k
    for k in ("hdr_texture", "gt_albedo", "gt_roughness", "seg_texture"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert a.size == b.size and a.lamp_radiance == b.lamp_radiance
    for x, y in zip(a.roomseg, b.roomseg):
        assert np.array_equal(x, y)
    rooms = 4 if size == "small" else 9
    assert set(np.unique(b.roomseg[5])) == set(range(1, rooms + 1))
    if size == "bench":
        assert b.mesh.num_faces == 104076


def _cluster(c):
    return convert.cluster_scene_from_numpy(
        np.asarray(c.rows3), np.asarray(c.prims3), np.asarray(c.cluster_lo),
        np.asarray(c.cluster_hi), float(c.diameter), c.lb, c.has_uv,
        device="cpu")


@pytest.fixture(scope="module")
def setup():
    syn = JS.make_building_scene(**SMALL)
    bvh = build_bvh(syn.mesh.vertices, syn.mesh.faces)
    fan = FanScene.from_flat(bvh, triangle_uvs=syn.mesh.triangle_uvs())
    jo = extract_occluders(syn.mesh)
    js = {lb: J.ClusterScene.from_fan(fan, lb=lb, dense=True) for lb in (4, 8)}
    jp = J.ClusterScene.proxy_from_fan(fan, k=64)
    tfan = TFan.from_flat(t_build_bvh(syn.mesh.vertices, syn.mesh.faces),
                          triangle_uvs=syn.mesh.triangle_uvs())
    rng = np.random.default_rng(23)
    lo, hi = np.array([0.4, 0.3, 0.4]), np.array([9.6, 2.7, 9.6])
    # bake rows: one shared origin each, texels in tight runs of four
    pts = (np.repeat(rng.uniform(lo, hi, (ROWS // 4, 3)), 4, 0)
           + rng.uniform(-0.1, 0.1, (ROWS, 3))).astype(np.float32)
    d = rng.standard_normal((ROWS, R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ds = J.sort_dirs_octant(tuple(jnp.asarray(d[..., k]) for k in range(3)))
    # G-buffer rows: one camera, pixel directions in coherent cones
    cam = np.float32([2.5, 1.5, 2.5])
    axis = rng.standard_normal((ROWS, 1, 3))
    dg = (axis + 0.3 * rng.standard_normal((ROWS, R, 3))).astype(np.float32)
    dg /= np.linalg.norm(dg, axis=-1, keepdims=True)
    # specular rows: each ray from its own point near its row's centre
    po = (rng.uniform(lo, hi, (ROWS // 2, 1, 3)) + rng.uniform(
        -0.05, 0.05, (ROWS // 2, R, 3))).astype(np.float32)
    dp = rng.standard_normal((ROWS // 2, R, 3)).astype(np.float32)
    dp /= np.linalg.norm(dp, axis=-1, keepdims=True)

    def planes(x):
        return tuple(np.ascontiguousarray(x[..., k]) for k in range(3))

    return dict(
        syn=syn, fan=fan, tfan=tfan, jo=jo, js=js, jp=jp,
        ts={lb: _cluster(c) for lb, c in js.items()}, tp=_cluster(jp),
        to=convert.occluders_from_numpy(
            jo.axis, np.asarray(jo.p), np.asarray(jo.rect_lo),
            np.asarray(jo.rect_hi), float(jo.sep_margin), device="cpu"),
        rays={
            "shared_uv": (planes(pts), tuple(np.array(a) for a in ds)),
            "shared_prim": (tuple(np.full(ROWS, c, np.float32) for c in cam),
                            planes(dg)),
            "per_ray_uv": (planes(po), planes(dp)),
        },
    )


def test_proxy_from_fan_matches_jax(setup):
    s = setup
    for k in (64, 1024):  # 1024 > the 496 triangles: all of them
        a = J.ClusterScene.proxy_from_fan(s["fan"], k=k)
        b = T.ClusterScene.proxy_from_fan(s["tfan"], k=k, device="cpu")
        for name in ("rows3", "prims3", "cluster_lo", "cluster_hi"):
            assert np.array_equal(np.asarray(getattr(a, name)),
                                  getattr(b, name).numpy()), (k, name)
        assert (a.lb, a.has_uv, float(a.diameter)) == (b.lb, b.has_uv,
                                                      b.diameter)
    prims = b.prims3.numpy().reshape(-1)
    assert (prims >= 0).sum() == s["syn"].mesh.num_faces
    # the k largest triangles, kept in DFS order
    m = s["syn"].mesh
    e = m.vertices[m.faces]
    area = np.linalg.norm(np.cross(e[:, 1] - e[:, 0], e[:, 2] - e[:, 0]), axis=-1)
    p64 = s["tp"].prims3.numpy().reshape(-1)
    p64 = p64[p64 >= 0]
    assert len(p64) == 64
    assert area[p64].min() >= np.sort(area)[-64] * (1 - 1e-6)


# the three shapes of the main path: (walk kwargs, cluster size, JAX kwargs)
MODES = {
    # JAX runs blocks of one exit group (fan_block 4): the same groups and
    # hits, and half the interpret-mode program of a block of two
    "shared_uv": (dict(fan_block=8, exit_rows=4, emit_uv=True), 4,
                  dict(fan_block=4)),
    "shared_prim": (dict(fan_block=8, exit_rows=0, emit_prim=True,
                         t_min=1e-6), 8, {}),
    # one exit group per row: JAX runs blocks of one row, whose
    # interpret-mode program compiles ~8x faster than a block of eight
    "per_ray_uv": (dict(fan_block=8, exit_rows=1, per_ray=True,
                        emit_uv=True), 8, dict(fan_block=1)),
}


def _t(x):
    return tuple(map(torch.from_numpy, x))


def _np(h):
    return [np.array(a) for a in (h.t, h.prim, h.u, h.v)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_seeded_walk_matches_jax(setup, mode):
    s = setup
    kw, lb, jkw = MODES[mode]
    o, d = s["rays"][mode]
    scene, occ = s["ts"][lb], s["to"]
    before = dict(T.culled_walk_cuda.launches)
    seed = T.cast_fans_culled(s["tp"], _t(o), _t(d), occluders=occ, **kw)
    seeded = _np(T.cast_fans_culled(scene, _t(o), _t(d), seed=seed,
                                    occluders=occ, **kw))
    # seeding is exact: the same hits as unseeded, and as with the proxy
    for other in (dict(), dict(proxy=s["tp"])):
        h = _np(T.cast_fans_culled(scene, _t(o), _t(d), occluders=occ,
                                   **other, **kw))
        for a, b in zip(seeded, h):
            assert np.array_equal(a, b)
    assert T.culled_walk_cuda.launches == before  # the CPU runs no kernel
    ref = _np(J.cast_fans_culled(
        s["js"][lb], tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)),
        seed=JHit(*(jnp.asarray(a.numpy()) for a in
                    (seed.t, seed.prim, seed.u, seed.v))),
        occluders=s["jo"], interpret=True, **dict(kw, **jkw)))
    assert np.array_equal(seeded[0], ref[0])
    assert np.array_equal(seeded[1], ref[1])
    assert np.abs(seeded[2] - ref[2]).max() <= UV_TOL
    assert np.abs(seeded[3] - ref[3]).max() <= UV_TOL
    assert np.isfinite(seeded[0]).mean() > 0.99
    if mode == "shared_prim":
        assert (seeded[1] >= 0).all()
    else:
        assert (seeded[1] == -1).all()
    # the 64 largest triangles (the interior wall panels) seed some rays
    assert np.isfinite(seed.t.numpy()).mean() > 0.05


def test_seed_counts_match_jax(setup):
    """The candidate lists cut at each group's worst seed t: the port's
    seed_counts against the counts the JAX kernel walks with (its
    debug_emit_visits telemetry writes them into v), and the port's own
    telemetry (B1 (e), the plain walk: u = clusters each exit group
    visited, v = its count) equal to JAX's, with the same hits."""
    s = setup
    # the G-buffer's narrow cones, in exit groups of four rows at lb 4:
    # a group's worst ray ends at a near wall, short of the far clusters
    kw = dict(fan_block=8, exit_rows=4, emit_prim=True, t_min=1e-6)
    o, d = s["rays"]["shared_prim"]
    scene, er = s["ts"][4], kw["exit_rows"]
    # a proxy of every triangle: every ray of the closed building is
    # seeded, so each group's worst seed t is finite
    whole = T.ClusterScene.proxy_from_fan(s["tfan"], k=1024, device="cpu")
    seed = T.cast_fans_culled(whole, _t(o), _t(d), occluders=s["to"], **kw)
    assert np.isfinite(seed.t.numpy()).all()
    cand, count, dist = T.cull_blocks(scene, _t(o), _t(o), _t(d), er,
                                      occluders=s["to"])
    g = count.numel()
    t_cap = float(np.float32(1.05) * np.float32(scene.diameter))
    got = T.seed_counts(dist.reshape(g, -1), seed.t, t_cap).numpy()
    full = count.reshape(g).numpy()
    assert (got <= full).all() and got.sum() < full.sum()
    # JAX in blocks of one exit group (the same groups, counts and hits)
    ref = J.cast_fans_culled(
        s["js"][4], tuple(map(jnp.asarray, o)), tuple(map(jnp.asarray, d)),
        seed=JHit(*(jnp.asarray(a.numpy()) for a in
                    (seed.t, seed.prim, seed.u, seed.v))),
        occluders=s["jo"], interpret=True, debug_emit_visits=True,
        **dict(kw, fan_block=er))
    assert np.array_equal(np.asarray(ref.v)[::er, 0].astype(np.int32), got)
    tel = T.cast_fans_culled(scene, _t(o), _t(d), seed=seed,
                             occluders=s["to"], debug_emit_visits=True, **kw)
    for a, b in ((tel.t, ref.t), (tel.prim, ref.prim), (tel.u, ref.u),
                 (tel.v, ref.v)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    visits = tel.u.numpy()[::er, 0]
    # a seeded group walks at least one cluster when it has candidates
    assert ((visits >= 1) == (got >= 1)).all() and (visits <= got).all()
