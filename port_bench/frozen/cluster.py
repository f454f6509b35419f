"""Frozen copy of the port's culled-walk packing, culling and plain walk,
as the port has them when the benchmark was defined
(texir_code_tpu_torch/ops/fan_raycast.py: the plane-dual leaf rows and
`closest_hit_block`; texir_code_tpu_torch/ops/pallas_culled.py: the dense
cluster packing, `cull_blocks`, `culled_walk_plain` and the wedge helpers).

port_bench.roofline counts the tests a walk needs with it, so that the
count stays the same whatever later implements the walk.  Do not edit:
the yardstick would move with it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench.frozen.bvh import FlatBVH
from port_bench.frozen.occluders import occluder_blocked_clusters

Vec3s = tuple

FAN_ROW_WIDTH = 72

FAN_ROW_WIDTH_UV = 96

_TRI_BASE = 12

_TRI_STRIDE = 15

_UV_BASE = 72

_DET_EPS = 1e-12

_BARY_EPS = 1e-7


@dataclasses.dataclass
class FanScene:
    """Leaf rows with plane-dual triangle data (host numpy)."""

    rows: np.ndarray  # [L, 72 | 96] float32 (prim ids as float bit patterns)
    diameter: float   # scene AABB diagonal, rounded to float32

    @classmethod
    def from_flat(cls, bvh: FlatBVH, triangle_uvs=None) -> "FanScene":
        """Args:
            triangle_uvs: optional [F*3, 2] per-corner uvs (mesh.triangle_uvs);
                when given, rows carry interpolation coefficients for the
                atlas uv at the hit (used by the uv-emitting walk).
        """
        if bvh.leaf_width != 4:
            raise ValueError("fan tracing assumes leaf_width == 4")
        is_leaf = bvh.leaf_count > 0
        idx = np.nonzero(is_leaf)[0]
        l = len(idx)
        width = FAN_ROW_WIDTH_UV if triangle_uvs is not None else FAN_ROW_WIDTH
        rows = np.zeros((l, width), np.float32)
        rows[:, 0:3] = bvh.aabb_min[idx]
        rows[:, 3:6] = bvh.aabb_max[idx]
        rows[:, 6] = bvh.leaf_count[idx].view(np.float32)
        starts = bvh.leaf_start[idx]
        for j in range(4):
            sl = starts + j
            p0 = bvh.tri_p0[sl].astype(np.float64)
            e1 = bvh.tri_e1[sl].astype(np.float64)
            e2 = bvh.tri_e2[sl].astype(np.float64)
            n = np.cross(e1, e2)
            nn = np.maximum((n * n).sum(-1, keepdims=True), 1e-30)
            s1 = np.cross(e2, n) / nn
            s2 = np.cross(n, e1) / nn
            rows[:, 8 + j] = bvh.tri_prim[sl].view(np.float32)
            base = _TRI_BASE + _TRI_STRIDE * j
            rows[:, base : base + 3] = n.astype(np.float32)
            rows[:, base + 3] = (n * p0).sum(-1).astype(np.float32)
            rows[:, base + 4 : base + 7] = s1.astype(np.float32)
            rows[:, base + 7] = (s1 * p0).sum(-1).astype(np.float32)
            rows[:, base + 8 : base + 11] = s2.astype(np.float32)
            rows[:, base + 11] = (s2 * p0).sum(-1).astype(np.float32)
            rows[:, base + 12 : base + 15] = p0.astype(np.float32)
            # degenerate padded slots: zero normal → |n·d| below eps → no hit
            if triangle_uvs is not None:
                prim = bvh.tri_prim[sl]
                safe = np.maximum(prim, 0)
                t0 = triangle_uvs[safe * 3]
                t1 = triangle_uvs[safe * 3 + 1]
                t2 = triangle_uvs[safe * 3 + 2]
                ub = _UV_BASE + 6 * j
                rows[:, ub] = t0[:, 0]
                rows[:, ub + 1] = t1[:, 0] - t0[:, 0]
                rows[:, ub + 2] = t2[:, 0] - t0[:, 0]
                rows[:, ub + 3] = t0[:, 1]
                rows[:, ub + 4] = t1[:, 1] - t0[:, 1]
                rows[:, ub + 5] = t2[:, 1] - t0[:, 1]
        lo = bvh.aabb_min.min(axis=0)
        hi = bvh.aabb_max.max(axis=0)
        return cls(
            rows=rows,
            diameter=float(np.float32(np.linalg.norm(hi - lo))),
        )


def closest_hit_block(tri, uvc, pids, origins, dirs, hit, t_min: float,
                      emit_uv: bool):
    """Closest hits of ray sets against blocks of K plane-dual triangles:
    the plain PyTorch form of the kernels' inner loop (ops.pallas_culled,
    ops.pallas_fan).

    Every accept test but `t < t_best` is the triangle's own, so a block's
    hit is its smallest accepted t — the first such triangle in row order
    on a tie (`torch.min` returns the first minimum), as the kernels'
    sequential loop keeps it — and it replaces the running hit only when
    strictly closer.  The arithmetic is the kernels', in their order.

    Args:
        tri: [N, K, 15] triangle records (rows[:, 12:72] per row, 4 a row,
            in row order) for N ray sets (N = 1: shared by all).
        uvc: [N, K, 6] atlas-uv coefficients (rows[:, 72:96]), with emit_uv.
        pids: [N, K] int32 prim ids, or None (prim is kept as it is).
        origins / dirs: 3-tuples of [N, A, B] (origins may be [N, A, 1]).
        hit: (t, prim, u, v) running state, each [N, A, B].
    Returns:
        the updated (t, prim, u, v).
    """
    n, k = tri.shape[:2]

    def col(i):
        return tri[:, :, i].reshape(n, k, 1, 1)

    ox, oy, oz = (a.unsqueeze(1) for a in origins)
    dx, dy, dz = (a.unsqueeze(1) for a in dirs)
    nx, ny, nz, pd = (col(i) for i in range(4))
    s1x, s1y, s1z, p0s1 = (col(4 + i) for i in range(4))
    s2x, s2y, s2z, p0s2 = (col(8 + i) for i in range(4))
    no = nx * ox + ny * oy + nz * oz
    ou = s1x * ox + s1y * oy + s1z * oz - p0s1
    ov = s2x * ox + s2y * oy + s2z * oz - p0s2
    nd = nx * dx + ny * dy + nz * dz
    ok_nd = torch.abs(nd) > _DET_EPS
    inv_nd = torch.where(ok_nd, 1.0 / torch.where(ok_nd, nd, 1.0), 0.0)
    t = (pd - no) * inv_nd
    du = s1x * dx + s1y * dy + s1z * dz
    dv = s2x * dx + s2y * dy + s2z * dz
    uu = ou + t * du
    vv = ov + t * dv
    ok = (ok_nd & (torch.minimum(uu, vv) >= -_BARY_EPS)
          & (uu + vv <= 1.0 + _BARY_EPS) & (t > t_min))
    inf = torch.full((), float("inf"), device=t.device)
    t_k, idx = torch.min(torch.where(ok, t, inf), dim=1)

    def pick(a):  # [N, K] per-triangle values at each ray's triangle
        return torch.gather(a, 1, idx.reshape(n, -1)).reshape(idx.shape)

    uk = torch.gather(uu, 1, idx.unsqueeze(1)).squeeze(1)
    vk = torch.gather(vv, 1, idx.unsqueeze(1)).squeeze(1)
    if emit_uv:
        w = [pick(uvc[:, :, i]) for i in range(6)]
        uk, vk = (w[0] + uk * w[1] + vk * w[2],
                  w[3] + uk * w[4] + vk * w[5])
    t_best, prim, u_best, v_best = hit
    take = t_k < t_best
    if pids is not None:
        prim = torch.where(take, pick(pids), prim)
    return (torch.where(take, t_k, t_best), prim,
            torch.where(take, uk, u_best), torch.where(take, vk, v_best))


_ROW_PAD = 128          # cluster rows padded to 128 columns

_PLAIN_ELEMS = 1 << 25  # per-triangle terms the plain walk holds at once

_PRIM_ROWS = 8          # prims3 is [C, 8, 128] int32, as the JAX package's


@dataclasses.dataclass
class ClusterScene:
    """Cluster-major leaf rows + cluster AABBs (tensors on one device)."""

    rows3: torch.Tensor
    prims3: torch.Tensor
    cluster_lo: torch.Tensor
    cluster_hi: torch.Tensor
    diameter: float
    lb: int = 32
    has_uv: bool = False

    @property
    def num_clusters(self) -> int:
        return int(self.rows3.shape[0])

    @classmethod
    def from_fan(cls, fan: FanScene, lb: int, device) -> "ClusterScene":
        """The dense packing (ClusterScene.from_fan(dense=True))."""
        rows = fan.rows
        has_uv = rows.shape[1] >= FAN_ROW_WIDTH_UV
        rows = _densepack_rows(rows, has_uv, lb=lb)
        rows3, prims3, lo, hi = _pack_clusters(rows, lb)
        dev = torch.device(device)
        return cls(
            rows3=torch.from_numpy(rows3).to(dev),
            prims3=torch.from_numpy(prims3).to(dev),
            cluster_lo=torch.from_numpy(lo).to(dev),
            cluster_hi=torch.from_numpy(hi).to(dev),
            diameter=float(np.float32(fan.diameter)),
            lb=lb,
            has_uv=has_uv,
        )


def _pack_clusters(rows: np.ndarray, lb: int):
    """[L, W] rows → (rows3 [C, lb, 128], prims3 [C, 8, 128], lo, hi)."""
    l, w = rows.shape
    c = (l + lb - 1) // lb
    rows3 = np.zeros((c, lb, _ROW_PAD), np.float32)
    rows3[:, :, :w].reshape(c * lb, w)[:l] = rows
    # prim ids live in rows cols 8:12 as float bit patterns
    prims = rows[:, 8:12].view(np.int32)  # [L, 4]
    prims3 = np.full((c, _PRIM_ROWS, _ROW_PAD), -1, np.int32)
    flat = np.full((c * lb, 4), -1, np.int32)
    flat[:l] = prims
    if lb * 4 > _PRIM_ROWS * _ROW_PAD:
        raise ValueError(f"cluster size {lb} > {_PRIM_ROWS * _ROW_PAD // 4}")
    pr = flat.reshape(c, lb * 4)
    full_rows, rem = divmod(lb * 4, _ROW_PAD)
    for rr in range(full_rows):
        prims3[:, rr, :] = pr[:, rr * _ROW_PAD : (rr + 1) * _ROW_PAD]
    if rem:
        prims3[:, full_rows, :rem] = pr[:, full_rows * _ROW_PAD :]

    lo = np.full((c, 3), np.inf, np.float32)
    hi = np.full((c, 3), -np.inf, np.float32)
    for ci in range(c):
        sl = rows[ci * lb : min((ci + 1) * lb, l)]
        # skip all-zero padded leaf rows (they carry no geometry)
        valid = np.abs(sl[:, _TRI_BASE:_TRI_BASE + 3]).sum(axis=1) > 0
        valid |= sl[:, 3:6].sum(axis=1) != sl[:, 0:3].sum(axis=1)
        if valid.any():
            lo[ci] = sl[valid, 0:3].min(axis=0)
            hi[ci] = sl[valid, 3:6].max(axis=0)
        else:
            lo[ci] = 0.0
            hi[ci] = 0.0
    return rows3, prims3, lo, hi


def _densepack_rows(
    rows: np.ndarray, has_uv: bool, li=None, ki=None, split_planes=None,
    lb: int = 1,
) -> np.ndarray:
    """Repack leaf rows' valid triangles densely, 4 per row, DFS order.

    Cols 12:72 are four contiguous stride-15 triangle records and 72:96
    four 6-float uv records, so the repack is a flat reshape; cols 0:6
    (row AABB) become the union of each triangle's source-leaf AABB.
    li/ki optionally select a triangle subset (row, slot indices).

    split_planes + lb: break the packing into fresh lb-aligned cluster
    boundaries whenever consecutive DFS triangles lie in different regions
    of the occluder-plane arrangement (per source-leaf AABB signs:
    strictly-below / on / strictly-above per plane), so no cluster
    straddles a plane of the set (see ClusterScene.from_fan)."""
    l, w = rows.shape
    prims = rows[:, 8:12].view(np.int32)  # [L, 4]
    if li is None:
        li, ki = np.nonzero(prims >= 0)  # row-major → DFS triangle order
    n = len(li)

    if split_planes is not None and n and split_planes.num_occluders:
        # region signature per triangle from its source-leaf AABB
        lo_t = rows[li, 0:3]
        hi_t = rows[li, 3:6]
        m = float(split_planes.sep_margin)
        p_np = split_planes.p.detach().cpu().numpy()
        seen = set()
        planes = []
        for i in range(split_planes.num_occluders):
            key = (int(split_planes.axis[i]), round(float(p_np[i]), 6))
            if key in seen:
                continue
            seen.add(key)
            planes.append(key)
        sig = np.zeros((n, len(planes)), np.int8)
        for col, (k, p) in enumerate(planes):
            sig[:, col] = np.where(
                hi_t[:, k] <= p - m, 0,
                np.where(lo_t[:, k] >= p + m, 2, 1),
            )
        # region-MAJOR packing: the DFS crosses plane regions thousands of
        # times (run-level breaks measured 100% padding), so triangles are
        # stable-sorted by (region id, morton of leaf center) — one
        # cluster-aligned break per REGION, spatial coherence restored
        # within each region by the morton key
        _, region = np.unique(sig, axis=0, return_inverse=True)
        centers = (lo_t + hi_t) * 0.5
        span = centers.max(axis=0) - centers.min(axis=0) + 1e-9
        q = ((centers - centers.min(axis=0)) / span * 1023).astype(np.int64)

        def _spread(x):
            x = (x | (x << 16)) & 0x030000FF
            x = (x | (x << 8)) & 0x0300F00F
            x = (x | (x << 4)) & 0x030C30C3
            x = (x | (x << 2)) & 0x09249249
            return x

        morton = (
            _spread(q[:, 0]) | (_spread(q[:, 1]) << 1)
            | (_spread(q[:, 2]) << 2)
        )
        order = np.lexsort((morton, region))
        li, ki = li[order], ki[order]
        region = region[order]
        change = np.concatenate([[True], region[1:] != region[:-1]])
        run_start = np.flatnonzero(change)
        run_len = np.diff(np.concatenate([run_start, [n]]))
        # rows per region, rounded up to whole clusters (lb rows)
        rows_per_run = -(-run_len // 4)
        rows_per_run = -(-rows_per_run // lb) * lb
        run_row0 = np.concatenate([[0], np.cumsum(rows_per_run[:-1])])
        run_of_tri = np.repeat(np.arange(len(run_start)), run_len)
        idx_in_run = np.arange(n) - run_start[run_of_tri]
        row_idx = run_row0[run_of_tri] + idx_in_run // 4
        slot = idx_in_run % 4
        l2 = int(run_row0[-1] + rows_per_run[-1]) if len(run_start) else 0
    else:
        row_idx = np.arange(n) // 4
        slot = np.arange(n) % 4
        l2 = (n + 3) // 4

    tri_cols = (_TRI_BASE + _TRI_STRIDE * ki)[:, None] + np.arange(_TRI_STRIDE)
    tri_rec = np.zeros((l2, 4, _TRI_STRIDE), np.float32)
    tri_rec[row_idx, slot] = rows[li[:, None], tri_cols]

    out = np.zeros((l2, w), np.float32)
    out[:, _TRI_BASE:_TRI_BASE + 4 * _TRI_STRIDE] = tri_rec.reshape(l2, -1)
    if has_uv:
        uv_cols = (_UV_BASE + 6 * ki)[:, None] + np.arange(6)
        uv_rec = np.zeros((l2, 4, 6), np.float32)
        uv_rec[row_idx, slot] = rows[li[:, None], uv_cols]
        out[:, _UV_BASE:_UV_BASE + 24] = uv_rec.reshape(l2, -1)

    pr = np.full((l2, 4), -1, np.int32)
    pr[row_idx, slot] = prims[li, ki]
    out[:, 8:12] = pr.view(np.float32)

    lo = np.full((l2, 4, 3), np.inf, np.float32)
    hi = np.full((l2, 4, 3), -np.inf, np.float32)
    lo[row_idx, slot] = rows[li, 0:3]
    hi[row_idx, slot] = rows[li, 3:6]
    out[:, 0:3] = lo.min(axis=1)
    out[:, 3:6] = hi.max(axis=1)
    # fully-padded rows would carry an infinite AABB; zero it
    bad = ~np.isfinite(out[:, 0:6]).all(axis=1)
    out[bad, 0:6] = 0.0
    return out


def sort_dirs_octant(dirs: Vec3s) -> Vec3s:
    """Sort each fan's directions by octant key (per row of [T, S]).

    A stable sort, as the reference's `lax.sort`: directions of one octant
    keep their order.  The irradiance estimator is order-invariant, so hits
    are consumed in sorted order — no inverse permutation is needed."""
    dx, dy, dz = dirs
    key = (
        (dx < 0).to(torch.int32) * 4
        + (dy < 0).to(torch.int32) * 2
        + (dz < 0).to(torch.int32)
    )
    order = torch.argsort(key, dim=1, stable=True)
    return tuple(torch.gather(a, 1, order) for a in dirs)


def wedge_rows(x: torch.Tensor, g: int) -> torch.Tensor:
    """[T, S] → [G*T, S/G] wedge-major (row w*T+f = fan f's wedge w)."""
    t, s = x.shape
    return x.reshape(t, g, s // g).transpose(0, 1).reshape(g * t, s // g)


def tile_rows(x: torch.Tensor, g: int) -> torch.Tensor:
    """Per-fan [T] values → per-wedge-row [G*T] (wedge-major)."""
    return x.repeat(g)


def cull_blocks(
    scene: ClusterScene, o_lo: Vec3s, o_hi: Vec3s, dirs: Vec3s, tf: int,
    occluders=None,
):
    """Per-group candidate cluster lists, sorted near-to-far.

    Static tests per (group of tf rows, cluster): swept-beam AABB overlap
    (length = scene diameter) + front-halfspace, both against the group's
    joint origin box and direction cone, and a direction-projected lower
    bound on t.  Returns cand [RB, 1, C] int32 nearest-first (stable
    argsort), count [RB, 1, 1] int32, dist [RB, 1, C] float32 sorted bounds.

    occluders: optional geometry.occluders.OccluderSet of proven
    mesh-covered rectangles; clusters every ray of a group could reach only
    through one are removed — exactly (see geometry.occluders)."""
    tp = dirs[0].shape[0]
    rb = tp // tf
    c = scene.num_clusters
    diam = scene.diameter
    dev = dirs[0].device

    bo_lo, bo_hi, d_lo, d_hi = [], [], [], []
    for k in range(3):
        bo_lo.append(o_lo[k].reshape(rb, tf).amin(dim=1))
        bo_hi.append(o_hi[k].reshape(rb, tf).amax(dim=1))
        d = dirs[k].reshape(rb, tf, -1)
        d_lo.append(d.amin(dim=(1, 2)))
        d_hi.append(d.amax(dim=(1, 2)))

    inf = torch.full((), float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    overlap = torch.ones((rb, c), dtype=torch.bool, device=dev)
    front = torch.zeros((rb, c), device=dev)
    dist2 = torch.zeros((rb, c), device=dev)
    t_lb = torch.zeros((rb, c), device=dev)
    for k in range(3):
        c_lo = scene.cluster_lo[:, k][None, :]
        c_hi = scene.cluster_hi[:, k][None, :]
        lo_k = (bo_lo[k] + diam * torch.clamp_max(d_lo[k], 0.0))[:, None]
        hi_k = (bo_hi[k] + diam * torch.clamp_min(d_hi[k], 0.0))[:, None]
        overlap &= (c_lo <= hi_k) & (c_hi >= lo_k)
        r_lo = c_lo - bo_hi[k][:, None]
        r_hi = c_hi - bo_lo[k][:, None]
        dl = d_lo[k][:, None]
        dh = d_hi[k][:, None]
        front += torch.maximum(
            torch.maximum(r_lo * dl, r_lo * dh),
            torch.maximum(r_hi * dl, r_hi * dh),
        )
        # direction-projected t lower bound: a hit at o + t*d must close
        # each axis gap with that axis's best-case direction component —
        # clusters off to the side of a narrow wedge sort late (or never)
        gap_p = r_lo  # > 0 when the cluster is on the + side
        gap_m = -r_hi  # > 0 when the cluster is on the - side
        dp = torch.clamp_min(dh, 0.0)
        dm = torch.clamp_min(-dl, 0.0)
        bound_p = torch.where(
            gap_p > 0.0,
            torch.where(dp > 1e-12, gap_p / torch.clamp_min(dp, 1e-12), inf),
            zero,
        )
        bound_m = torch.where(
            gap_m > 0.0,
            torch.where(dm > 1e-12, gap_m / torch.clamp_min(dm, 1e-12), inf),
            zero,
        )
        t_lb = torch.maximum(t_lb, torch.maximum(bound_p, bound_m))
        gap = torch.clamp_min(torch.maximum(gap_p, gap_m), 0.0)
        dist2 += gap * gap
    ok = overlap & (front >= 0.0) & torch.isfinite(t_lb)
    if occluders is not None and occluders.num_occluders:
        ok &= ~occluder_blocked_clusters(
            occluders, bo_lo, bo_hi, d_lo, d_hi,
            scene.cluster_lo, scene.cluster_hi,
        )
    dist = torch.maximum(torch.sqrt(dist2), t_lb)
    key = torch.where(ok, dist, inf)
    order = torch.argsort(key, dim=1, stable=True)
    dist_sorted = torch.gather(key, 1, order)
    count = ok.sum(dim=1).to(torch.int32)
    return (
        order.to(torch.int32)[:, None, :],
        count[:, None, None],
        dist_sorted[:, None, :],
    )


def culled_walk_plain(
    count, cand, dist, t_cap: float, origins, dx, dy, dz, rows3, prims3,
    er: int, t_min: float = 0.0, emit_uv: bool = False,
    emit_prim: bool = True, per_ray: bool = False, seed=None,
):
    """The walk in plain PyTorch: the CPU path and the kernel's oracle.

    Same arguments and results as `culled_walk`.  Vectorised over all exit
    groups, it loops over candidate index j and keeps the TPU kernel's
    group-wide exit: a group is live while j < count and the next bound is
    below min(max t_best over the group, t_cap), its threshold starting at
    inf (seeded or not) and refreshed after each visit.  Only live groups
    are gathered and tested."""
    g = count.shape[0]
    n_rows, r = dx.shape
    c = cand.shape[1]
    lb = rows3.shape[1]
    dev = dx.device
    shape = (g, er, r)
    d = [a.reshape(shape) for a in (dx, dy, dz)]
    if per_ray:
        o = [origins[k].reshape(shape) for k in range(3)]
    else:
        o = [origins[:, k].reshape(g, er, 1) for k in range(3)]
    if seed is None:
        t_best = torch.full(shape, float("inf"), device=dev)
        u_best = torch.zeros(shape, device=dev)
        v_best = torch.zeros(shape, device=dev)
    else:
        t_best, u_best, v_best = (
            seed[i].reshape(shape).clone() for i in (0, 2, 3))
    if seed is not None and emit_prim:
        prim = seed[1].reshape(shape).clone()
    else:
        prim = torch.full(shape, -1, dtype=torch.int32, device=dev)
    thr = torch.full((g,), float("inf"), device=dev)
    live = torch.ones((g,), dtype=torch.bool, device=dev)
    n_visited = torch.zeros((g,), dtype=torch.int32, device=dev)
    count_l = count.long()
    k = 4 * lb
    # live groups tested at once: bounds each block's [n, K, er, R] terms
    per_chunk = max(1, _PLAIN_ELEMS // (k * er * r))
    for j in range(c):
        live &= (j < count_l) & (dist[:, j] < torch.clamp_max(thr, t_cap))
        idx_all = torch.nonzero(live).squeeze(1)
        if idx_all.numel() == 0:
            break
        n_visited += live.to(torch.int32)
        for idx in idx_all.split(per_chunk):
            cid = cand[idx, j].long()
            rows = rows3[cid]  # [n, lb, 128]
            n = len(cid)
            tri = rows[:, :, _TRI_BASE:_TRI_BASE + 4 * _TRI_STRIDE].reshape(
                n, k, _TRI_STRIDE)
            uvc = (rows[:, :, _UV_BASE:_UV_BASE + 24].reshape(n, k, 6)
                   if emit_uv else None)
            pids = prims3[cid].reshape(n, -1)[:, :k] if emit_prim else None
            hit = closest_hit_block(
                tri, uvc, pids, tuple(a[idx] for a in o),
                tuple(a[idx] for a in d),
                (t_best[idx], prim[idx], u_best[idx], v_best[idx]), t_min,
                emit_uv)
            t_best[idx], prim[idx], u_best[idx], v_best[idx] = hit
            thr[idx] = hit[0].amax(dim=(1, 2))
    return tuple(
        a.reshape(n_rows, r) for a in (t_best, prim, u_best, v_best)
    )
