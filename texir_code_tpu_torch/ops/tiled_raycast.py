"""Tiled ("stream") ray casting: closest hits by dense tile × leaf streams.

The port of the JAX package's `ops/tiled_raycast.py`, its design for a
TPU, where a gathered row costs far more than broadcast arithmetic: the
per-ray gathers of a BVH traversal are traded for elementwise work over
coherent tiles of rays.

  1. **Sort rays into tiles** by a coherence key (direction octant, then
     the origin's Morton cell), stably.  A tile's rays share a
     conservative swept volume: per axis [omin + D·min(dmin, 0),
     omax + D·max(dmax, 0)], D the scene diameter.
  2. **Cull leaves per tile, densely**: one [T, L] swept-box overlap and
     front-half-space test, then the first ≤K overlapping leaves of each
     tile in ascending leaf id (a stable sort of the {0, 1} overlap,
     `jax.lax.top_k`'s order among equal scores).
  3. **Dense intersection stream**: for k = 0..K-1 gather leaf k of every
     tile ([T, 48]) and test all R rays of the tile against its 4
     triangles with broadcast Möller–Trumbore (ops.raycast), the first
     visited triangle winning an exact-t tie.  A step here takes as many
     consecutive leaves as fit in `_STREAM_ELEMS` tests (the same hits).
  4. Put the hits back in the input order.

Exact when K covers every tile's overlapping leaves (`required_leaf_budget`);
`cast_rays_exact` re-traces the rays of overflowing tiles with the BVH
traversal (ops.raycast.cast_rays_soa).  Everything here is plain PyTorch,
as it is XLA in the JAX package: no hand-written kernel.  JAX runs the
stream as one `lax.scan`; here it is a host loop of a few dozen
elementwise launches a step that reads no device value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.ops.raycast import (
    RayHit,
    Vec3s,
    _moller_trumbore_soa,
    cast_rays_soa,
)

LEAF_ROW_WIDTH = 48  # 6 aabb + 1 count + 1 pad + 4 prim + 4×9 tris
_STREAM_ELEMS = 1 << 25  # ray-triangle tests a step of the stream holds


@dataclasses.dataclass
class TiledScene:
    """Leaf-level scene arrays for tiled tracing.

    leaf_rows: [L, 48] float32 — per leaf: aabb_min(3), aabb_max(3), count
        (int32 bitcast), pad, 4× prim id (int32 bitcast), 4× (p0, e1, e2).
    diameter: the scene diameter bound for swept-volume culling (a float32
        value).
    """

    leaf_rows: torch.Tensor
    diameter: float

    @property
    def num_leaves(self) -> int:
        return int(self.leaf_rows.shape[0])

    @classmethod
    def from_flat(cls, bvh, device="cuda") -> "TiledScene":
        """From a geometry.bvh.FlatBVH of leaf width 4; rows on `device`
        (default the card; raises without one)."""
        if bvh.leaf_width != 4:
            raise ValueError("tiled tracing assumes leaf_width == 4")
        dev = resolve_device(device)
        rows_idx = np.nonzero(bvh.leaf_count > 0)[0]
        rows = np.zeros((len(rows_idx), LEAF_ROW_WIDTH), np.float32)
        rows[:, 0:3] = bvh.aabb_min[rows_idx]
        rows[:, 3:6] = bvh.aabb_max[rows_idx]
        rows[:, 6] = bvh.leaf_count[rows_idx].view(np.float32)
        starts = bvh.leaf_start[rows_idx]
        for j in range(4):
            sl = starts + j
            rows[:, 8 + j] = bvh.tri_prim[sl].view(np.float32)
            rows[:, 12 + 9 * j:15 + 9 * j] = bvh.tri_p0[sl]
            rows[:, 15 + 9 * j:18 + 9 * j] = bvh.tri_e1[sl]
            rows[:, 18 + 9 * j:21 + 9 * j] = bvh.tri_e2[sl]
        lo = bvh.aabb_min.min(axis=0)
        hi = bvh.aabb_max.max(axis=0)
        diam = float(np.float32(np.linalg.norm(hi - lo)))
        return cls(leaf_rows=torch.from_numpy(rows).to(dev), diameter=diam)


def _morton3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
             bits: int = 5) -> torch.Tensor:
    """Interleave `bits` bits of each of three non-negative integer
    coordinates."""
    out = torch.zeros_like(x)
    for b in range(bits):
        out = out | (((x >> b) & 1) << (3 * b + 2))
        out = out | (((y >> b) & 1) << (3 * b + 1))
        out = out | (((z >> b) & 1) << (3 * b))
    return out


def ray_sort_keys(
    origins: Vec3s,
    dirs: Vec3s,
    scene_lo: Vec3s,
    scene_inv_extent: Vec3s,
    cell_bits: int = 4,
) -> torch.Tensor:
    """Coherence keys (int32): direction octant (3 bits), then the origin's
    Morton cell of `cell_bits` bits an axis.  scene_lo / scene_inv_extent:
    float32 scalars (0-dim tensors or the values as floats)."""
    oct_key = (
        ((dirs[0] >= 0).to(torch.int32) << 2)
        | ((dirs[1] >= 0).to(torch.int32) << 1)
        | (dirs[2] >= 0).to(torch.int32)
    )
    n_cells = (1 << cell_bits) - 1
    cells = []
    for k in range(3):
        c = (origins[k] - scene_lo[k]) * scene_inv_extent[k] * (1 << cell_bits)
        # clamped before the conversion: truncation then clipping, as JAX's
        # astype + clip, with no out-of-range float-to-int conversion
        cells.append(torch.clamp(c, 0, n_cells).to(torch.int32))
    morton = _morton3(cells[0], cells[1], cells[2], cell_bits)
    return (oct_key << (3 * cell_bits)) | morton


def _candidate_leaves(overlap: torch.Tensor, k: int) -> torch.Tensor:
    """[T, k] leaf ids a tile: its overlapping leaves in ascending id, then
    the others in ascending id.  A stable sort of the {0, 1} scores, which
    is jax.lax.top_k's order among equal scores (torch.topk fixes none)."""
    return torch.sort(overlap.to(torch.int8), dim=1, descending=True,
                      stable=True).indices[:, :k]


def cast_rays_tiled(
    scene: TiledScene,
    origins: Vec3s,
    dirs: Vec3s,
    t_min: float = 0.0,
    tile_size: int = 1024,
    max_leaves: int = 256,
    sort_rays: bool = True,
    cell_bits: int = 4,
    return_overflow: bool = False,
):
    """Closest-hit trace via tile-coherent dense leaf streaming.

    Args:
        scene: TiledScene (its rows on the rays' device).
        origins / dirs: 3-tuples of same-shape float32 component tensors;
            the flattened ray count must be a multiple of tile_size
            (callers pad).
        t_min: minimum hit distance.
        tile_size: rays per tile (R).
        max_leaves: K, the per-tile candidate-leaf budget.  A tile whose
            swept volume overlaps more than K leaves tests only its first
            K and may miss hits; choose K with `required_leaf_budget`, or
            take `return_overflow` and re-trace (cast_rays_exact).
        sort_rays: sort by coherence key first (off for pre-sorted inputs).
    Returns:
        RayHit with the input shape; with return_overflow, (RayHit, over):
        over [shape] bool marks the rays of tiles that overflowed K.
        `cast_rays_tiled.stats` holds the last call's tiles and leaf steps.
    """
    shape = origins[0].shape
    o = tuple(a.reshape(-1) for a in origins)
    d = tuple(a.reshape(-1) for a in dirs)
    b = o[0].shape[0]
    if b % tile_size:
        raise ValueError(f"ray count {b} not a multiple of tile_size {tile_size}")
    n_tiles = b // tile_size
    dev = o[0].device

    leaf = scene.leaf_rows
    n_leaves = leaf.shape[0]
    lc_all = leaf[:, 6].view(torch.int32)
    prim_all = leaf[:, 8:12].view(torch.int32)
    tri_all = leaf[:, 12:48].reshape(n_leaves, 4, 9)

    # ---- 1. sort rays into tiles ------------------------------------------
    scene_lo = leaf[:, 0:3].amin(dim=0)
    scene_hi = leaf[:, 3:6].amax(dim=0)
    inv_ext = 1.0 / torch.clamp_min(scene_hi - scene_lo, 1e-6)
    if sort_rays:
        keys = ray_sort_keys(o, d, scene_lo, inv_ext, cell_bits)
        order = torch.argsort(keys, stable=True)
        o = tuple(a[order] for a in o)
        d = tuple(a[order] for a in d)
    to = tuple(a.reshape(n_tiles, tile_size) for a in o)
    td = tuple(a.reshape(n_tiles, tile_size) for a in d)

    # ---- 2. dense tile × leaf culling -------------------------------------
    # (a) swept-box overlap: per axis the tile's rays reach
    #     [omin + D·min(dmin,0), omax + D·max(dmax,0)];
    # (b) front half-space: a leaf is reachable only if the interval bound
    #     of (c - o)·d over its corners c, the tile's origins o and
    #     directions d is >= 0
    diam = scene.diameter
    overlap = torch.ones((n_tiles, n_leaves), dtype=torch.bool, device=dev)
    front = torch.zeros((n_tiles, n_leaves), dtype=torch.float32, device=dev)
    for k in range(3):
        omin, omax = to[k].amin(dim=1), to[k].amax(dim=1)
        dmin, dmax = td[k].amin(dim=1), td[k].amax(dim=1)
        box_lo = omin + diam * torch.clamp_max(dmin, 0.0)
        box_hi = omax + diam * torch.clamp_min(dmax, 0.0)
        overlap &= leaf[None, :, k] <= box_hi[:, None]
        overlap &= leaf[None, :, 3 + k] >= box_lo[:, None]
        r_lo = leaf[None, :, k] - omax[:, None]
        r_hi = leaf[None, :, 3 + k] - omin[:, None]
        dlo, dhi = dmin[:, None], dmax[:, None]
        front = front + torch.maximum(
            torch.maximum(r_lo * dlo, r_lo * dhi),
            torch.maximum(r_hi * dlo, r_hi * dhi),
        )
    overlap &= front >= 0.0

    kk = min(max_leaves, n_leaves)
    leaf_ids = _candidate_leaves(overlap, kk)
    counts = overlap.sum(dim=1)  # may exceed kk
    # no leaf step past the largest list changes a hit: one read, before
    # the loop
    steps = min(kk, int(counts.amax())) if n_tiles else 0
    cast_rays_tiled.stats = dict(tiles=n_tiles, steps=steps)

    # ---- 3. dense intersection stream -------------------------------------
    # `chunk` consecutive leaf steps at once, their 4 triangles each as one
    # [chunk·4, T, R] test (at most _STREAM_ELEMS elements); the first
    # smallest t among them (leaf after leaf, triangle after triangle)
    # replaces the best only when strictly closer, which is JAX's
    # sequential rule (t < t_best at every triangle)
    t_best = torch.full((n_tiles, tile_size), float("inf"), device=dev)
    prim = torch.full((n_tiles, tile_size), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((n_tiles, tile_size), device=dev)
    v_best = torch.zeros((n_tiles, tile_size), device=dev)
    oo = tuple(a[None, None] for a in to)
    dd = tuple(a[None, None] for a in td)
    j = torch.arange(4, device=dev)[None, :, None, None]
    inf = torch.tensor(float("inf"), device=dev)
    chunk = max(1, _STREAM_ELEMS // (4 * b))
    for k0 in range(0, steps, chunk):
        k1 = min(k0 + chunk, steps)
        ids = leaf_ids[:, k0:k1]                              # [T, S]
        ks = torch.arange(k0, k1, device=dev)
        valid = (ks[:, None] < counts[None])[:, None, :, None]  # [S, 1, T, 1]
        tri = tri_all[ids].permute(1, 2, 3, 0)[..., None]     # [S, 4, 9, T, 1]
        p0 = (tri[:, :, 0], tri[:, :, 1], tri[:, :, 2])
        e1 = (tri[:, :, 3], tri[:, :, 4], tri[:, :, 5])
        e2 = (tri[:, :, 6], tri[:, :, 7], tri[:, :, 8])
        hit, t, u, v = _moller_trumbore_soa(oo, dd, p0, e1, e2, t_min)
        lc = lc_all[ids].t()[:, None, :, None]                 # [S, 1, T, 1]
        ok = hit & valid & (j < lc)                            # [S, 4, T, R]
        n_tri = ok.shape[0] * 4
        t_j, jj = torch.min(torch.where(ok, t, inf).reshape(n_tri, n_tiles,
                                                             tile_size), dim=0)
        closer = t_j < t_best
        t_best = torch.where(closer, t_j, t_best)
        pj = torch.gather(prim_all[ids].reshape(n_tiles, n_tri), 1, jj)
        prim = torch.where(closer, pj, prim)
        jj = jj[None]
        u_best = torch.where(closer, torch.gather(
            u.reshape(n_tri, n_tiles, tile_size), 0, jj)[0], u_best)
        v_best = torch.where(closer, torch.gather(
            v.reshape(n_tri, n_tiles, tile_size), 0, jj)[0], v_best)

    # ---- 4. unsort --------------------------------------------------------
    def flat(a):
        a = a.reshape(-1)
        if not sort_rays:
            return a.reshape(shape)
        out = torch.empty_like(a)
        out[order] = a
        return out.reshape(shape)

    hit = RayHit(t=flat(t_best), prim=flat(prim), u=flat(u_best),
                 v=flat(v_best))
    if not return_overflow:
        return hit
    # a ray of a tile with more candidate leaves than kk may have missed
    # its closest hit (callers re-trace those rays exactly)
    over = (counts > kk)[:, None].expand(n_tiles, tile_size)
    return hit, flat(over.contiguous())


cast_rays_tiled.stats = dict(tiles=0, steps=0)


def cast_rays_exact(
    scene: TiledScene,
    bvh,
    origins: Vec3s,
    dirs: Vec3s,
    t_min: float = 0.0,
    tile_size: int = 1024,
    max_leaves: int = 256,
    sort_rays: bool = True,
    cell_bits: int = 4,
) -> RayHit:
    """The tiled trace, with the rays of overflowing tiles re-traced by the
    BVH traversal (ops.raycast.cast_rays_soa on `bvh`, a DeviceBVH on the
    rays' device) in one batch padded to a multiple of 128: one host read
    a call.  `cast_rays_exact.stats` holds the last call's re-traced
    rays."""
    hit, over = cast_rays_tiled(
        scene, origins, dirs, t_min=t_min, tile_size=tile_size,
        max_leaves=max_leaves, sort_rays=sort_rays, cell_bits=cell_bits,
        return_overflow=True,
    )
    idx = torch.nonzero(over.reshape(-1)).reshape(-1)
    n = idx.numel()
    cast_rays_exact.stats = dict(retraced=n)
    if n == 0:
        return hit
    pad = 128 - (n % 128 or 128)
    idx_p = torch.cat([idx, idx.new_zeros(pad)]) if pad else idx
    sub = cast_rays_soa(
        bvh, tuple(a.reshape(-1)[idx_p] for a in origins),
        tuple(a.reshape(-1)[idx_p] for a in dirs), t_min=t_min)
    shape = origins[0].shape

    def put(a, s):
        a = a.reshape(-1).clone()
        a[idx] = s[:n]
        return a.reshape(shape)

    return RayHit(t=put(hit.t, sub.t), prim=put(hit.prim, sub.prim),
                  u=put(hit.u, sub.u), v=put(hit.v, sub.v))


cast_rays_exact.stats = dict(retraced=0)


def required_leaf_budget(
    scene: TiledScene,
    origins: Vec3s,
    dirs: Vec3s,
    tile_size: int = 1024,
    cell_bits: int = 4,
) -> int:
    """Host helper: the largest per-tile overlapping-leaf count (the swept
    box test alone) of this ray population, to choose max_leaves (run once
    on representative rays).  numpy on the host, with numpy's default
    argsort of the keys as the JAX helper's."""
    o = tuple(a.detach().reshape(-1).cpu().numpy() for a in origins)
    d = tuple(a.detach().reshape(-1).cpu().numpy() for a in dirs)
    leaf = scene.leaf_rows.cpu().numpy()
    lo = leaf[:, 0:3].min(axis=0)
    hi = leaf[:, 3:6].max(axis=0)
    inv_ext = 1.0 / np.maximum(hi - lo, 1e-6)
    keys = ray_sort_keys(
        tuple(torch.from_numpy(a) for a in o),
        tuple(torch.from_numpy(a) for a in d),
        tuple(torch.tensor(v) for v in lo),
        tuple(torch.tensor(v) for v in inv_ext),
        cell_bits,
    ).numpy()
    order = np.argsort(keys)
    diam = float(scene.diameter)
    n_tiles = len(order) // tile_size
    worst = 0
    for t in range(n_tiles):
        sel = order[t * tile_size:(t + 1) * tile_size]
        blo, bhi = [], []
        for k in range(3):
            omin, omax = o[k][sel].min(), o[k][sel].max()
            dmin, dmax = d[k][sel].min(), d[k][sel].max()
            blo.append(omin + diam * min(dmin, 0.0))
            bhi.append(omax + diam * max(dmax, 0.0))
        ov = np.ones(leaf.shape[0], bool)
        for k in range(3):
            ov &= leaf[:, k] <= bhi[k]
            ov &= leaf[:, 3 + k] >= blo[k]
        worst = max(worst, int(ov.sum()))
    return worst

