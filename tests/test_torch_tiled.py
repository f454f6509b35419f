"""Port vs JAX: the tiled ray caster (`ops/tiled_raycast.py`) — the leaf
rows, the sort keys, the tile and candidate order, `cast_rays_tiled` with
and without overflow, `cast_rays_exact` and `required_leaf_budget`.

Both packages trace the same BVH (the JAX package's build_bvh arrays,
copied into the port's FlatBVH) with the same rays (numpy from a seed).  The JAX side
is XLA on the CPU (no Pallas).  The leaf rows and the keys are equal bit
for bit; the hits hold prim equal but on exact-t ties, t/u/v within fp32
rounding (XLA may contract a multiply-add in the barycentric terms, the
port rounds each product: measured up to 1.5e-6 in u), and the overflow
flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texir_code_tpu.data.synthetic import make_scene
from texir_code_tpu.geometry.bvh import build_bvh
from texir_code_tpu.ops import tiled_raycast as J
from texir_code_tpu.ops.raycast import DeviceBVH as JBVH
from texir_code_tpu_torch.geometry.bvh import FlatBVH
from texir_code_tpu_torch.ops import tiled_raycast as T
from texir_code_tpu_torch.ops.raycast import DeviceBVH, cast_rays_soa

torch.set_num_threads(2)  # six test workers share the host's cores

TILE = 256
TOL = 1e-5


@pytest.fixture(scope="module")
def room():
    """The JAX test's room (make_scene(atlas_res=32, subdiv=8), 200 leaves)
    and two ray sets of 4096: uniform origins and directions (the JAX
    test's), and four clusters of origins (camera-like), whose tiles
    overflow at half the budget on some tiles and not on others."""
    rng = np.random.default_rng(1)
    scene = make_scene(atlas_res=32, subdiv=8)
    fb = build_bvh(scene.mesh.vertices, scene.mesh.faces)
    tfb = FlatBVH(**{f: getattr(fb, f) for f in (
        "aabb_min", "aabb_max", "miss", "leaf_start", "leaf_count", "tri_p0",
        "tri_e1", "tri_e2", "tri_prim", "leaf_width")})
    b = 4096
    o = (rng.random((b, 3)) * [3.0, 2.0, 4.0] + 0.5).astype(np.float32)
    d = rng.normal(size=(b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rng = np.random.default_rng(3)
    cams = (rng.random((4, 3)) * 0.6 + 0.2) * np.asarray(scene.size)
    o2 = (np.repeat(cams, b // 4, axis=0)
          + rng.uniform(-0.05, 0.05, (b, 3))).astype(np.float32)
    d2 = rng.normal(size=(b, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return dict(fb=fb, tfb=tfb, js=J.TiledScene.from_flat(fb),
                ts=T.TiledScene.from_flat(tfb, device="cpu"),
                rays={"uniform": (o, d), "clustered": (o2, d2)}, jax={})


def _j(a):
    return tuple(jnp.asarray(a[:, k]) for k in range(3))


def _t(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k]))
                 for k in range(3))


def _hits(h):
    return [np.asarray(a) if not torch.is_tensor(a) else a.numpy()
            for a in (h.t, h.prim, h.u, h.v)]


def _assert_hits_close(ref, got):
    """prim equal but on exact-t ties; t/u/v within fp32 rounding."""
    t0, p0, u0, v0 = ref
    t1, p1, u1, v1 = got
    fin = np.isfinite(t0)
    assert np.array_equal(fin, np.isfinite(t1))
    assert fin.mean() > 0.5
    assert np.abs(t0[fin] - t1[fin]).max() <= TOL
    tie = (p0 != p1)
    dt = np.abs(np.where(fin, t0, 0.0) - np.where(fin, t1, 0.0))
    assert (tie & (dt > 0)).sum() == 0
    assert tie.mean() < 1e-3
    same = ~tie
    assert np.abs(u0 - u1)[same].max() <= TOL
    assert np.abs(v0 - v1)[same].max() <= TOL


def test_leaf_rows_bit_equal(room):
    js, ts = room["js"], room["ts"]
    a = np.asarray(js.leaf_rows)
    assert ts.leaf_rows.shape == a.shape == (ts.num_leaves, T.LEAF_ROW_WIDTH)
    assert ts.leaf_rows.dtype == torch.float32
    np.testing.assert_array_equal(a.view(np.int32),
                                  ts.leaf_rows.numpy().view(np.int32))
    assert ts.diameter == float(js.diameter)


def test_leaf_width_must_be_four(room):
    import dataclasses

    with pytest.raises(ValueError, match="leaf_width"):
        T.TiledScene.from_flat(dataclasses.replace(room["tfb"], leaf_width=2),
                               device="cpu")


def test_from_flat_needs_a_card_unless_cpu(room):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the rows would go to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.TiledScene.from_flat(room["tfb"])


@pytest.mark.parametrize("rays", ["uniform", "clustered"])
def test_sort_keys_and_tile_order_match_jax(room, rays):
    o, d = room["rays"][rays]
    leaf = np.asarray(room["js"].leaf_rows)
    lo = leaf[:, 0:3].min(axis=0)
    inv = 1.0 / np.maximum(leaf[:, 3:6].max(axis=0) - lo, 1e-6)
    kj = np.asarray(J.ray_sort_keys(_j(o), _j(d),
                                    tuple(jnp.float32(v) for v in lo),
                                    tuple(jnp.float32(v) for v in inv)))
    kt = T.ray_sort_keys(_t(o), _t(d), tuple(torch.tensor(v) for v in lo),
                         tuple(torch.tensor(v) for v in inv))
    assert kt.dtype == torch.int32
    np.testing.assert_array_equal(kj, kt.numpy())
    # the tiles are the stable order's, jnp.argsort (clustered origins:
    # many rays share a key)
    if rays == "clustered":
        assert len(np.unique(kj)) < len(kj) // 4
    np.testing.assert_array_equal(np.asarray(jnp.argsort(jnp.asarray(kj))),
                                  torch.argsort(kt, stable=True).numpy())


def test_morton3_matches_jax():
    rng = np.random.default_rng(2)
    x, y, z = (rng.integers(0, 32, 500, dtype=np.int32) for _ in range(3))
    a = J._morton3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    b = T._morton3(*(torch.from_numpy(v) for v in (x, y, z)))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("k", [7, 40, 64])
def test_candidate_order_matches_top_k(k):
    """The first k candidate leaves of each tile: the overlapping leaves in
    ascending id, then the others in ascending id — jax.lax.top_k's order
    on {0, 1} scores."""
    rng = np.random.default_rng(k)
    overlap = rng.random((32, 64)) < rng.random((32, 1))
    overlap[0] = False
    overlap[1] = True
    _, want = jax.lax.top_k(jnp.asarray(overlap.astype(np.int8)), k)
    got = T._candidate_leaves(torch.from_numpy(overlap), k)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _jax_cast(room, rays, **kw):
    key = (rays, tuple(sorted(kw.items())))
    if key not in room["jax"]:
        o, d = room["rays"][rays]
        out = J.cast_rays_tiled(room["js"], _j(o), _j(d), tile_size=TILE,
                                **kw)
        if kw.get("return_overflow"):
            room["jax"][key] = (_hits(out[0]), np.asarray(out[1]))
        else:
            room["jax"][key] = _hits(out)
    return room["jax"][key]


def _port_cast(room, rays, **kw):
    o, d = room["rays"][rays]
    out = T.cast_rays_tiled(room["ts"], _t(o), _t(d), tile_size=TILE, **kw)
    if kw.get("return_overflow"):
        return _hits(out[0]), out[1].numpy()
    return _hits(out)


@pytest.mark.parametrize("rays", ["uniform", "clustered"])
def test_required_leaf_budget_matches_jax(room, rays):
    o, d = room["rays"][rays]
    b = T.required_leaf_budget(room["ts"], _t(o), _t(d), tile_size=TILE)
    assert b == J.required_leaf_budget(room["js"], _j(o), _j(d),
                                       tile_size=TILE)
    assert 0 < b <= room["ts"].num_leaves


@pytest.mark.parametrize("case", ["budget", "all_leaves", "unsorted"])
def test_cast_rays_tiled_matches_jax(room, case):
    o, d = room["rays"]["clustered"]
    ts = room["ts"]
    kw = {"budget": dict(max_leaves=T.required_leaf_budget(
              ts, _t(o), _t(d), tile_size=TILE)),
          "all_leaves": dict(max_leaves=ts.num_leaves),
          "unsorted": dict(max_leaves=ts.num_leaves, sort_rays=False)}[case]
    _assert_hits_close(_jax_cast(room, "clustered", **kw),
                       _port_cast(room, "clustered", **kw))


@pytest.mark.parametrize("rays", ["uniform", "clustered"])
def test_overflow_flags_and_hits_match_jax(room, rays):
    """A budget of half the leaves: some tiles overflow (the flags and the
    truncated hits both equal JAX's), others do not."""
    kw = dict(max_leaves=room["ts"].num_leaves // 2, return_overflow=True)
    ref, over_j = _jax_cast(room, rays, **kw)
    got, over_t = _port_cast(room, rays, **kw)
    np.testing.assert_array_equal(over_j, over_t)
    assert 0 < over_t.mean() < 1
    _assert_hits_close(ref, got)


def test_cast_rays_exact_matches_jax(room):
    o, d = room["rays"]["clustered"]
    kw = dict(tile_size=TILE, max_leaves=room["ts"].num_leaves // 4)
    ref = J.cast_rays_exact(room["js"], JBVH.from_flat(room["fb"]), _j(o),
                            _j(d), **kw)
    bvh = DeviceBVH.from_flat(room["tfb"], "cpu")
    got = T.cast_rays_exact(room["ts"], bvh, _t(o), _t(d), **kw)
    _assert_hits_close(_hits(ref), _hits(got))
    # and the overflowing rays now carry the traversal's exact hits
    full = cast_rays_soa(bvh, _t(o), _t(d))
    _assert_hits_close(_hits(full), _hits(got))


def test_tiled_matches_traversal(room):
    """The port's tiled trace and its BVH traversal on the same rays: the
    same Möller–Trumbore test, so t/u/v agree bit for bit wherever prim
    does, and prim differs only on exact-t ties (visit order)."""
    o, d = room["rays"]["uniform"]
    ts = room["ts"]
    got = _port_cast(room, "uniform", max_leaves=ts.num_leaves)
    want = _hits(cast_rays_soa(DeviceBVH.from_flat(room["tfb"], "cpu"),
                               _t(o), _t(d)))
    _assert_hits_close(want, got)
    same = got[1] == want[1]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[same], b[same])


def test_stream_chunks_change_no_hit(room, monkeypatch):
    """A step of the stream takes as many leaves as fit in _STREAM_ELEMS
    tests: 7 leaves a step, or 1, gives the hits of all leaves in one."""
    o, d = room["rays"]["clustered"]
    whole = T.cast_rays_tiled(room["ts"], _t(o), _t(d), tile_size=TILE,
                              max_leaves=room["ts"].num_leaves)
    for leaves in (7, 1):
        monkeypatch.setattr(T, "_STREAM_ELEMS", 4 * len(o) * leaves)
        part = T.cast_rays_tiled(room["ts"], _t(o), _t(d), tile_size=TILE,
                                 max_leaves=room["ts"].num_leaves)
        for f in ("t", "prim", "u", "v"):
            assert torch.equal(getattr(whole, f), getattr(part, f))


def test_t_min_respected(room):
    # shooting from the floor: t_min filters the immediate self-hit
    n = TILE
    o = (torch.full((n,), 2.0), torch.full((n,), 1.0), torch.zeros(n))
    d = (torch.zeros(n), torch.zeros(n), torch.ones(n))
    hit = T.cast_rays_tiled(room["ts"], o, d, t_min=1e-4, tile_size=TILE,
                            max_leaves=room["ts"].num_leaves)
    assert (hit.t > 1.0).all()  # crosses the room to the far wall (z≈5)


def test_ray_count_must_fill_tiles(room):
    o, d = room["rays"]["uniform"]
    with pytest.raises(ValueError, match="multiple of tile_size"):
        T.cast_rays_tiled(room["ts"], _t(o[:1000]), _t(d[:1000]),
                          tile_size=TILE)
