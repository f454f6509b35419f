"""Culled cluster walk — closest hits sub-linear in scene size.

The port of the JAX package's `ops/pallas_culled.py`: the walk of the
bake's shared-origin wedge rows, the G-buffer's pixel rows and the
specular trace's per-ray rows, unseeded or seeded by an occlusion proxy,
and the two-pass trace:

  1. **Direction wedges.**  Each fan's S hemisphere directions are sorted
     by octant and split into G chunks ("wedges") of R = S/G rays, so a
     block of wedge rows has a tight joint direction cone and origin box.
  2. **Static cone culling** (`cull_blocks`, PyTorch).  Per exit group and
     cluster: swept-beam overlap + front-halfspace tests give a candidate
     list, sorted near-to-far by a conservative distance bound; proven
     occluders (geometry.occluders) remove clusters behind walls.
  3. **The walk** (`culled_walk`).  Each ray tests the candidates
     nearest-first and stops once the next bound reaches its hit t.  On a
     CUDA tensor this is the hand-written kernel `csrc/culled_walk.cu`; on
     a CPU tensor it is `culled_walk_plain`, the same walk in plain
     PyTorch with the TPU kernel's group-wide exit.  A seed (the hits of
     an occlusion proxy, `ClusterScene.proxy_from_fan`) starts every ray
     at a valid upper bound on its t.
  4. **Two passes** (`cast_fans_culled_twopass`).  A walk truncated at a
     fraction of the scene diameter, then an exact re-trace of the few
     rays it left unresolved.

Results are exact: every cluster that could hold a closer hit lies in the
visited prefix.  Leaf rows reuse the FanScene plane-dual layout
(ops.fan_raycast), re-packed cluster-major [C, LB, 128]; the packing is
numpy and equal, array for array, to the JAX package's.

The file keeps the JAX module's name so each counterpart is easy to find;
nothing in it is Pallas.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from texir_code_tpu_torch import profiling
from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.ops.fan_raycast import (
    FAN_ROW_WIDTH_UV,
    _TRI_BASE,
    _TRI_STRIDE,
    _UV_BASE,
    FanScene,
    closest_hit_block,
)
from texir_code_tpu_torch.ops.raycast import RayHit, Vec3s

_ROW_PAD = 128          # cluster rows padded to 128 columns
_PLAIN_ELEMS = 1 << 25  # per-triangle terms the plain walk holds at once
_PRIM_ROWS = 8          # prims3 is [C, 8, 128] int32, as the JAX package's

@dataclasses.dataclass
class ClusterScene:
    """Cluster-major leaf rows + cluster AABBs (tensors on one device).

    Attributes:
        rows3: [C, LB, 128] float32 — FanScene rows grouped into clusters of
            LB consecutive leaves (BVH DFS order = spatially coherent).
        prims3: [C, 8, 128] int32 — prim ids; prims3[c, 0, 4*j + k] is
            triangle k of row j.
        cluster_lo / cluster_hi: [C, 3] cluster AABBs (over valid rows only).
        diameter: scene diameter (a float32 value; swept-beam length bound).
    """

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
    @profiling.timed("pack", "clusters")
    def from_fan(
        cls, fan: FanScene, lb: int = 32, dense: bool = False,
        split_planes=None, device="cuda",
    ) -> "ClusterScene":
        """Re-pack a FanScene's leaf rows into clusters of lb rows.

        dense=True repacks the triangles 4-per-row ignoring BVH leaf
        boundaries (DFS order preserved), so no test is spent on padding;
        row AABBs become the union of the contributing leaves' AABBs —
        conservative, so culling stays exact.  split_planes (an
        OccluderSet) starts a fresh cluster whenever the packing crosses
        one of its planes, so behind-wall geometry lands in cullable
        clusters."""
        rows = fan.rows
        has_uv = rows.shape[1] >= FAN_ROW_WIDTH_UV
        if dense:
            rows = _densepack_rows(
                rows, has_uv, split_planes=split_planes, lb=lb
            )
        return cls._from_rows(rows, lb, has_uv, fan.diameter, device)

    @classmethod
    def proxy_from_fan(
        cls, fan: FanScene, k: int = 1024, lb: int = 8, device="cuda",
    ) -> "ClusterScene":
        """Occlusion proxy: the scene's k largest-area triangles, kept in
        DFS order and dense-packed.

        In an indoor scan the biggest triangles are the walls, floors and
        ceilings.  Proxy triangles are scene triangles, so a proxy hit is a
        valid (possibly not closest) hit: tracing the proxy first gives
        every ray an upper bound on its true t, which seeds the walk of the
        full scene (cast_fans_culled(proxy=...)).  Exact."""
        rows = fan.rows
        has_uv = rows.shape[1] >= FAN_ROW_WIDTH_UV
        prims = rows[:, 8:12].view(np.int32)
        li, ki = np.nonzero(prims >= 0)
        # |n| = |e1 x e2| = 2*area: the plane rows carry n directly
        base = _TRI_BASE + _TRI_STRIDE * ki
        n = rows[li[:, None], base[:, None] + np.arange(3)]
        area = np.sqrt((n * n).sum(-1))
        k = min(k, len(li))
        # the k largest, back in DFS order (spatial coherence for its cull)
        top = np.sort(np.argsort(-area)[:k])
        packed = _densepack_rows(rows, has_uv, li=li[top], ki=ki[top])
        return cls._from_rows(packed, lb, has_uv, fan.diameter, device)

    @classmethod
    def _from_rows(cls, rows, lb, has_uv, diameter, device) -> "ClusterScene":
        rows3, prims3, lo, hi = _pack_clusters(rows, lb)
        dev = resolve_device(device)
        return cls(
            rows3=torch.from_numpy(rows3).to(dev),
            prims3=torch.from_numpy(prims3).to(dev),
            cluster_lo=torch.from_numpy(lo).to(dev),
            cluster_hi=torch.from_numpy(hi).to(dev),
            diameter=float(np.float32(diameter)),
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


# ---------------------------------------------------------------------------
# direction wedges
# ---------------------------------------------------------------------------


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


def unwedge_rows(x: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of wedge_rows: [G*T, R] → [T, G*R]."""
    gt, r = x.shape
    t = gt // g
    return x.reshape(g, t, r).transpose(0, 1).reshape(t, g * r)


def tile_rows(x: torch.Tensor, g: int) -> torch.Tensor:
    """Per-fan [T] values → per-wedge-row [G*T] (wedge-major)."""
    return x.repeat(g)


# ---------------------------------------------------------------------------
# static culling
# ---------------------------------------------------------------------------


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
    through one are removed — exactly (see geometry.occluders).

    Under the span `cull`; while a profiler records, the counts are held
    as `cull.candidates` and groups x clusters added to `cull.pairs`."""
    with profiling.span("cull"):
        return _cull_blocks(scene, o_lo, o_hi, dirs, tf, occluders)


def _cull_blocks(scene, o_lo, o_hi, dirs, tf, occluders):
    from texir_code_tpu_torch.geometry.occluders import occluder_blocked_clusters

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
    if profiling.recording():
        profiling.counter("cull")["pairs"] += rb * c
        profiling.hold("cull", "candidates", count)
    return (
        order.to(torch.int32)[:, None, :],
        count[:, None, None],
        dist_sorted[:, None, :],
    )


# ---------------------------------------------------------------------------
# the walk: plain PyTorch version and CUDA kernel
# ---------------------------------------------------------------------------


def culled_walk_plain(
    count, cand, dist, t_cap: float, origins, dx, dy, dz, rows3, prims3,
    er: int, t_min: float = 0.0, emit_uv: bool = False,
    emit_prim: bool = True, per_ray: bool = False, seed=None,
    visits: bool = False,
):
    """The walk in plain PyTorch: the CPU path and the kernel's oracle.

    Same arguments and results as `culled_walk`.  Vectorised over all exit
    groups, it loops over candidate index j and keeps the TPU kernel's
    group-wide exit: a group is live while j < count and the next bound is
    below min(max t_best over the group, t_cap), its threshold starting at
    inf (seeded or not) and refreshed after each visit.  Only live groups
    are gathered and tested; with `visits` it counts each group's visits."""
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
    if visits:
        u_best, v_best = _visit_telemetry(n_visited, count, er, r)
    return tuple(
        a.reshape(n_rows, r) for a in (t_best, prim, u_best, v_best)
    )


def _visit_telemetry(n_visited, count, er: int, r: int):
    """The TPU kernel's debug_emit_visits outputs: u = clusters each exit
    group visited, v = its candidate count, float32 over its er×R rays."""
    return tuple(
        a.to(torch.float32)[:, None].expand(-1, er * r).reshape(-1, er, r)
        for a in (n_visited, count)
    )


_SMEM_LIMIT = 48 * 1024  # default dynamic shared memory per block


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: expected device {device}, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _culled_walk_lib() -> ctypes.CDLL:
    from texir_code_tpu_torch.ops import cuda_build

    lib = cuda_build.load("culled_walk")
    fn = lib.texir_culled_walk
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, i, i, f, f, p, p, p, p, i, i, p, p, i, i, i,
                       i, p, p, p, p, p, p, p, p, p, p]
    return lib


def walk_mode(per_ray: bool, emit_uv: bool, emit_prim: bool,
              seeded: bool = False, visits: bool = False) -> str:
    """Name of a kernel mode, as `culled_walk_cuda.launches` counts it:
    'shared' or 'per_ray' origins, then '_uv' and/or '_prim' outputs, then
    '_seeded' when the hit state starts from a seed, then '_visits' with
    the visit telemetry (the bake runs 'shared_uv', the G-buffer
    'shared_prim', the specular trace 'per_ray_uv'; with an occlusion
    proxy, each of them '_seeded')."""
    name = "per_ray" if per_ray else "shared"
    return (name + ("_uv" if emit_uv else "") + ("_prim" if emit_prim else "")
            + ("_seeded" if seeded else "") + ("_visits" if visits else ""))


def culled_walk_cuda(
    count, cand, dist, t_cap: float, origins, dx, dy, dz, rows3, prims3,
    er: int, t_min: float = 0.0, emit_uv: bool = False,
    emit_prim: bool = True, per_ray: bool = False, seed=None,
    visits: bool = False,
):
    """Launch `csrc/culled_walk.cu` on the current stream (see culled_walk).

    Adds one to `culled_walk_cuda.launches[walk_mode(...)]` per launch."""
    dev = dx.device
    if dev.type != "cuda":
        raise ValueError(f"culled_walk_cuda needs CUDA tensors, got {dev}")
    g = count.shape[0]
    n_rows, r = dx.shape
    c = cand.shape[1]
    lb = rows3.shape[1]
    if n_rows != g * er:
        raise ValueError(f"{n_rows} rows are not {g} groups of {er}")
    _check("count", count, torch.int32, (g,), dev)
    _check("cand", cand, torch.int32, (g, c), dev)
    _check("dist", dist, torch.float32, (g, c), dev)
    if per_ray:
        # per-ray origins: three SoA planes [3, G*er, R]
        _check("origins (per_ray: [3, rows, R])", origins, torch.float32,
               (3, n_rows, r), dev)
    else:
        _check("origins (shared: [rows, 3])", origins, torch.float32,
               (n_rows, 3), dev)
    for name, a in (("dx", dx), ("dy", dy), ("dz", dz)):
        _check(name, a, torch.float32, (n_rows, r), dev)
    _check("rows3", rows3, torch.float32, (rows3.shape[0], lb, _ROW_PAD), dev)
    _check("prims3", prims3, torch.int32,
           (rows3.shape[0], _PRIM_ROWS, _ROW_PAD), dev)
    # one warp's two ring stages: 12 record floats and two origins' 4 terms
    # a triangle (csrc: stage_floats)
    if 2 * 4 * 4 * lb * (12 + 8) > _SMEM_LIMIT:
        raise ValueError(f"cluster size lb={lb} exceeds shared memory")
    if er * r > 65535 * 256:
        raise ValueError(f"exit group of {er}x{r} rays is too large")
    shape = (n_rows, r)
    # seed hit record (t, prim, u, v), each [rows, R]; null pointers leave
    # the kernel unseeded, and prim is read only with emit_prim
    seed_ptrs = [None] * 4
    if seed is not None:
        for i, (name, dtype) in enumerate((
                ("seed t", torch.float32), ("seed prim", torch.int32),
                ("seed u", torch.float32), ("seed v", torch.float32))):
            if name == "seed prim" and not emit_prim:
                continue
            _check(name, seed[i], dtype, shape, dev)
            seed_ptrs[i] = seed[i].data_ptr()
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    prim = torch.empty(shape, dtype=torch.int32, device=dev)
    u = torch.empty(shape, dtype=torch.float32, device=dev)
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    n_visited = (torch.zeros((g,), dtype=torch.int32, device=dev)
                 if visits else None)
    lib = _culled_walk_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.texir_culled_walk(
            count.data_ptr(), cand.data_ptr(), dist.data_ptr(), g, c,
            float(t_cap), float(t_min), origins.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), dz.data_ptr(), r, er, rows3.data_ptr(),
            prims3.data_ptr(), lb, int(per_ray), int(emit_uv),
            int(emit_prim), *seed_ptrs,
            None if n_visited is None else n_visited.data_ptr(),
            t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"culled_walk launch failed: cudaError {err}")
    mode = walk_mode(per_ray, emit_uv, emit_prim, seed is not None, visits)
    culled_walk_cuda.launches[mode] += 1
    if visits:
        u, v = (a.reshape(shape) for a in _visit_telemetry(n_visited, count,
                                                            er, r))
    return t, prim, u, v


# launches per kernel mode (walk_mode); callers reset it with .clear()
culled_walk_cuda.launches = profiling.counter("culled_walk.launches")


def culled_walk(
    count, cand, dist, t_cap: float, origins, dx, dy, dz, rows3, prims3,
    er: int, t_min: float = 0.0, emit_uv: bool = False,
    emit_prim: bool = True, per_ray: bool = False, seed=None,
    visits: bool = False,
):
    """Closest hits of ray rows over per-group candidate cluster lists.

    Args:
        count [G] int32, cand [G, C] int32, dist [G, C] float32: each exit
            group's candidate clusters nearest-first (cull_blocks) and
            their sorted lower bounds on t.
        t_cap: walk-stop distance (exit threshold cap).
        origins: [G*er, 3] float32, one shared origin per row; with
            per_ray, [3, G*er, R] float32, one origin per ray.
        dx, dy, dz [G*er, R] float32: directions; rows g*er..(g+1)*er-1
            form exit group g.
        rows3 [C', lb, 128] float32, prims3 [C', 8, 128] int32: clusters.
        seed: optional (t, prim, u, v), each [G*er, R] (float32, int32,
            float32, float32): valid hits the hit state starts from instead
            of (inf, -1, 0, 0); prim is read only with emit_prim.
        visits: the TPU kernel's debug_emit_visits telemetry: (u, v)
            become the clusters each exit group visited and its candidate
            count, as float32 over the group's rays.
    Returns:
        (t, prim, u, v), each [G*er, R]: t = +inf and prim = -1 on miss;
        prim is -1 throughout unless emit_prim; (u, v) are barycentrics,
        or the atlas uv of the hit with emit_uv.

    On CUDA tensors this launches the CUDA kernel (culled_walk_cuda); on
    CPU tensors it runs culled_walk_plain.  Under the span `walk`."""
    args = (count, cand, dist, t_cap, origins, dx, dy, dz, rows3, prims3, er,
            t_min, emit_uv, emit_prim, per_ray, seed, visits)
    if dx.device.type == "cuda":
        walk = culled_walk_cuda
    elif dx.device.type == "cpu":
        walk = culled_walk_plain
    else:
        raise ValueError(f"culled_walk: unsupported device {dx.device}")
    with profiling.span("walk"):
        return walk(*args)


def _pad_rows(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    """a with n rows of `fill` appended (dim 0)."""
    if not n:
        return a
    tail = torch.full((n,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, tail])


def seed_counts(dist: torch.Tensor, seed_t: torch.Tensor,
                t_cap: float) -> torch.Tensor:
    """Each group's candidate count cut at its worst seed t (capped).

    A cluster whose bound >= the group's worst seed t cannot strictly
    improve any ray of the group (hit t >= bound >= every ray's t_best);
    dist is sorted, so a smaller count truncates the list.

    Args:
        dist: [G, C] sorted bounds (cull_blocks; inf past the candidates).
        seed_t: [G*er, R] seed hit t of the groups' rays.
    Returns:
        [G] int32 counts."""
    g = dist.shape[0]
    bound = torch.clamp_max(seed_t.reshape(g, -1).amax(dim=1), t_cap)
    return (dist < bound[:, None]).sum(dim=1).to(torch.int32)


def walk_args(
    scene: ClusterScene,
    origins,
    dirs: Vec3s,
    t_min: float = 0.0,
    fan_block: int = 8,
    emit_uv: bool = False,
    per_ray: bool = False,
    exit_rows: int = 0,
    emit_prim: Optional[bool] = None,
    t_cap_frac: Optional[float] = None,
    cull=None,
    seed: Optional[RayHit] = None,
    occluders=None,
) -> dict:
    """The culled_walk arguments cast_fans_culled traces these rays with
    (same arguments as cast_fans_culled): the rows zero-padded to whole
    fan blocks, packed origins, each exit group's candidate list (from
    cull_blocks unless `cull` is given) and, with a seed, the padded seed
    and the counts cut at it (seed_counts)."""
    tp, r = dirs[0].shape
    tf = fan_block
    t_pad = (-tp) % tf
    o_rows, d = tuple(origins), tuple(dirs)
    if t_pad:
        o_rows = tuple(_pad_rows(a, t_pad, 0.0) for a in o_rows)
        d = tuple(_pad_rows(a, t_pad, 0.0) for a in d)
    er = exit_rows if (exit_rows and tf % exit_rows == 0) else tf
    if cull is None:
        if per_ray:
            # the groups' origin boxes widen by each row's spread
            # (conservative)
            cull_lo = tuple(a.amin(dim=1) for a in o_rows)
            cull_hi = tuple(a.amax(dim=1) for a in o_rows)
        else:
            cull_lo = cull_hi = o_rows
        cull = cull_blocks(scene, cull_lo, cull_hi, d, er, occluders=occluders)
    cand, count, dist = cull
    g = (tp + t_pad) // er
    cc = scene.num_clusters
    count = count.reshape(g).contiguous()
    cand = cand.reshape(g, cc).contiguous()
    dist = dist.reshape(g, cc).contiguous()
    if per_ray:
        o_pack = torch.stack(o_rows, dim=0).contiguous()  # [3, T', R]
    else:
        o_pack = torch.stack(o_rows, dim=-1).contiguous()  # [T', 3]
    # exit threshold cap = scene diameter (+ margin for surface-eps offset
    # origins): no real hit can be farther, so miss rays can't pin the exit
    cap_frac = 1.05 if t_cap_frac is None else t_cap_frac
    t_cap = float(np.float32(cap_frac) * np.float32(scene.diameter))
    seed_rows = None
    if seed is not None:
        seed_rows = tuple(
            _pad_rows(a[:tp], t_pad, fill).contiguous()
            for a, fill in ((seed.t, float("inf")), (seed.prim, -1),
                            (seed.u, 0.0), (seed.v, 0.0))
        )
        count = seed_counts(dist, seed_rows[0], t_cap)
    return dict(
        count=count, cand=cand, dist=dist, t_cap=t_cap, origins=o_pack,
        dx=d[0].contiguous(), dy=d[1].contiguous(), dz=d[2].contiguous(),
        rows3=scene.rows3, prims3=scene.prims3, er=er, t_min=t_min,
        emit_uv=emit_uv,
        emit_prim=(not emit_uv) if emit_prim is None else emit_prim,
        per_ray=per_ray, seed=seed_rows,
    )


def cast_fans_culled(
    scene: ClusterScene,
    origins,
    dirs: Vec3s,
    t_min: float = 0.0,
    fan_block: int = 8,
    emit_uv: bool = False,
    per_ray: bool = False,
    exit_rows: int = 0,
    emit_prim: Optional[bool] = None,
    t_cap_frac: Optional[float] = None,
    cull=None,
    seed: Optional[RayHit] = None,
    proxy: Optional[ClusterScene] = None,
    occluders=None,
    stream_cands: Optional[int] = None,
    debug_emit_visits: bool = False,
) -> RayHit:
    """Closest-hit trace of wedge rows with culled, early-exiting clusters.

    Args:
        origins: 3×[T'] per-row shared origins, or with per_ray 3×[T', R]
            per-ray origins (culling then uses per-row origin boxes).
        dirs: 3×[T', R] directions; rows should be direction-coherent (see
            sort_dirs_octant / wedge_rows).
        fan_block: rows per block; the rows are zero-padded to a multiple.
        exit_rows: rows per exit group (0, or a non-divisor of fan_block:
            one group per block); each group gets its own candidate list.
        emit_prim: default `not emit_uv` — the uv-emitting estimator never
            reads prim.
        t_cap_frac: walk-stop distance as a fraction of the scene diameter
            (default 1.05 = exact trace).  Fractions < 1 truncate the walk:
            hits with t <= t_cap_frac·diameter are exact; the two-pass
            trace (cast_fans_culled_twopass) re-traces the others.
        cull: optional precomputed cull_blocks result (cand, count, dist)
            for these (padded) rows and exit groups.
        seed: optional RayHit [T', R] of valid (possibly not closest) hits
            the walk starts from: per-ray upper bounds on t.  Each group's
            list is truncated at min(its worst seed t, cap): a cluster whose
            bound reaches it cannot strictly improve any ray of the group.
            Exact.
        proxy: optional occlusion-proxy ClusterScene
            (ClusterScene.proxy_from_fan), traced first with the same
            shape and occluders to make `seed` when seed is None.
        occluders: optional OccluderSet for exact PVS culling.
        stream_cands: accepted for signature parity; on the GPU the
            candidate tables live in device memory anyway, so it changes
            nothing.
        debug_emit_visits: telemetry instead of (u, v): u = clusters each
            exit group visited, v = its candidate count, as float32 over
            the group's rays (t and prim are the hits).
    Returns:
        RayHit of shape [T', R] — exact closest hits (when t_cap_frac
        covers the scene).
    """
    del stream_cands  # no shared-memory table limit to stream around
    if proxy is not None and seed is None:
        # occluders stay valid on the proxy subset: culling only weakens a
        # seed toward inf (a seed must be a valid hit or inf; both are)
        seed = cast_fans_culled(
            proxy, origins, dirs, t_min=t_min, fan_block=fan_block,
            emit_uv=emit_uv, per_ray=per_ray, exit_rows=exit_rows,
            emit_prim=emit_prim, occluders=occluders,
        )
    t, prim, u, v = culled_walk(**walk_args(
        scene, origins, dirs, t_min=t_min, fan_block=fan_block,
        emit_uv=emit_uv, per_ray=per_ray, exit_rows=exit_rows,
        emit_prim=emit_prim, t_cap_frac=t_cap_frac, cull=cull, seed=seed,
        occluders=occluders,
    ), visits=debug_emit_visits)
    tp = dirs[0].shape[0]
    return RayHit(t=t[:tp], prim=prim[:tp], u=u[:tp], v=v[:tp])


def cast_ray_fans_wedged(
    scene: ClusterScene,
    origins: Vec3s,
    dirs: Vec3s,
    wedges: int = 8,
    t_min: float = 0.0,
    fan_block: int = 8,
    emit_uv: bool = False,
    occluders=None,
):
    """A whole fan trace through direction wedges: sort, split, cull, walk.

    Each fan's directions are octant-sorted (sort_dirs_octant), split into
    `wedges` rows (wedge_rows) that share the fan's origin (tile_rows),
    traced by cast_fans_culled (kernel B1 on the card: `shared_uv` with
    emit_uv, else `shared_prim`; the plain walk on the CPU), and the hits
    put back in fan order.  The JAX function's `interpret` flag (Pallas's
    interpreter) has no counterpart here.

    Args:
        origins: 3×[T] per-fan origins; dirs: 3×[T, S] (S a multiple of
            wedges).
    Returns:
        (RayHit [T, S], dirs_sorted 3×[T, S]): the hits are aligned with
        the *sorted* directions, which the caller uses for estimation
        (order-invariant estimators take them as they are).
    """
    g = wedges
    ds = sort_dirs_octant(dirs)
    rows_d = tuple(wedge_rows(a, g) for a in ds)
    rows_o = tuple(tile_rows(a, g) for a in origins)
    hit = cast_fans_culled(
        scene, rows_o, rows_d, t_min=t_min, fan_block=fan_block,
        emit_uv=emit_uv, occluders=occluders,
    )
    return RayHit(*(unwedge_rows(a, g) for a in
                    (hit.t, hit.prim, hit.u, hit.v))), ds


def twopass_stragglers(
    scene: ClusterScene, t1: torch.Tensor, count: torch.Tensor,
    dist: torch.Tensor, cut_frac: float, cap_frac: float, tp: int, tf: int,
    er: int,
):
    """Pass 2's rays of the two-pass trace.

    Args:
        t1: [T'', R] pass-1 hit t of the rows padded to whole fan blocks.
        count / dist: the groups' untruncated candidate lists (cull_blocks).
        tp: rows before padding; tf / er: fan block and exit-group rows.
    Returns:
        (sel, cap_rows, n): sel [cap_rows·R] flat indices of the rays to
        re-trace, non-final rays first (a stable sort keeps the rows'
        coherence); cap_rows, the straggler capacity in rows; n, the
        number of non-final rays (they overflow when n > cap_rows·R).
        A ray is final if its hit t <= cut, if its group's whole list
        lies below cut, or if its row is padding.  Reading n is the
        trace's one device sync, under the span `twopass.sync`."""
    tpad, r = t1.shape
    cut = float(np.float32(cut_frac) * np.float32(scene.diameter))
    ngru = tpad // er
    dist2 = dist.reshape(ngru, scene.num_clusters)
    count2 = count.reshape(ngru).long()
    last = torch.gather(dist2, 1, torch.clamp_min(count2 - 1, 0)[:, None])[:, 0]
    group_final = ((count2 == 0) | (last < cut)).repeat_interleave(er)
    pad_row = torch.arange(tpad, device=t1.device) >= tp
    final = (t1 <= cut) | (group_final | pad_row)[:, None]
    # Python's round (to even), as the JAX package computes it
    cap_rows = max(tf, -(-int(round(cap_frac * tpad)) // tf) * tf)
    cap_rows = min(cap_rows, tpad)
    order = torch.argsort(final.reshape(-1).to(torch.int32), stable=True)
    stragglers = (~final).sum()
    with profiling.span("twopass.sync"):
        n = int(stragglers)
    return order[:cap_rows * r], cap_rows, n


def cast_fans_culled_twopass(
    scene: ClusterScene,
    origins,
    dirs: Vec3s,
    t_min: float = 0.0,
    fan_block: int = 8,
    exit_rows: int = 0,
    emit_uv: bool = False,
    cut_frac: float = 0.3,
    cap_frac: float = 0.125,
    per_ray: bool = False,
    proxy: Optional[ClusterScene] = None,
    cut_frac2: Optional[float] = None,
    cap_frac2: float = 0.25,
    occluders=None,
) -> RayHit:
    """Exact closest-hit trace in two passes (JAX
    `ops/pallas_culled.py::cast_fans_culled_twopass`).

      1. The walk is truncated at cut = cut_frac·diameter.  A ray is final
         if its hit t <= cut, or if its group's whole candidate list lies
         below cut (nothing was truncated).
      2. The other rays ("stragglers") are compacted by a stable sort into
         cap_rows dense rows and re-traced from scratch with per-ray
         origins (full cap, proxy and occluders); their hits are scattered
         back over pass 1's.

    If the stragglers overflow cap_rows, everything is traced once in full
    instead (the JAX package's `lax.cond`; here a host branch, one device
    sync per call).  `cast_fans_culled_twopass.counts` (the counter
    `twopass`) counts calls and overflows; while a profiler records, the
    counter `twopass.rays` counts pass 1's rays and its stragglers.
    Pass 2, or the full trace, runs under the span `twopass.retrace`.  cut_frac2 makes the re-trace a
    two-pass itself (the 3-pass ladder), with cap_frac2 of the compacted
    rows as its capacity.

    Why the hits equal the single pass's: a walk (the plain version's group
    exit, or the CUDA kernel's per-ray exit) stops a ray at the first
    candidate whose bound reaches min(t_best, cut) — its own t_best or its
    group's worst — and the bounds are sorted, so every cluster it skipped
    has bound >= min(t, cut) for its final pass-1 t.  A ray with t <= cut
    walked the same prefix as the single pass, in the same order and with
    the same arithmetic, and every skipped cluster can only tie, which the
    strict `t < t_best` rejects: its t, prim, u and v are the single pass's.
    Every ray with t > cut, under either exit, is re-traced in full.  So t
    is bit-equal; prim/u/v can differ only where two triangles tie exactly
    in t and the re-trace, with its own candidate order, meets the other
    one first.  One exception: a ray that leaks through a shared edge (the
    plane-dual test rejects both triangles) hits whatever its group's list
    holds next, and a pass-2 group, whose origins spread wider, can keep a
    cluster that a proven occluder dropped from the single pass's list.
    The single pass misses such a ray where the re-trace hits;
    tests/test_torch_leak.py holds the JAX package to the same miss.

    Args:
        origins: 3×[T] per-row shared origins (the bake layout), or
            3×[T, R] per-ray origins with per_ray=True (specular MC).
        cut_frac: pass-1 truncation, fraction of the scene diameter.
        cap_frac: straggler row capacity, fraction of T (rounded up to
            whole fan blocks).
    """
    tp, r = dirs[0].shape
    tf = fan_block
    t_pad = (-tp) % tf
    o_rows, d = tuple(origins), tuple(dirs)
    if t_pad:
        o_rows = tuple(_pad_rows(a, t_pad, 0.0) for a in o_rows)
        d = tuple(_pad_rows(a, t_pad, 0.0) for a in d)
    tpad = tp + t_pad
    er = exit_rows if (exit_rows and tf % exit_rows == 0) else tf
    counts = cast_fans_culled_twopass.counts
    counts["calls"] += 1

    if per_ray:
        o_lo = tuple(a.amin(dim=1) for a in o_rows)
        o_hi = tuple(a.amax(dim=1) for a in o_rows)
    else:
        o_lo = o_hi = o_rows
    cull = cull_blocks(scene, o_lo, o_hi, d, er, occluders=occluders)
    _, count, dist = cull
    # pass 1 walks the occluder-culled lists; its proxy pre-trace runs
    # without occluders, as the JAX package's does
    hit1 = cast_fans_culled(
        scene, o_rows, d, t_min=t_min, fan_block=tf, exit_rows=exit_rows,
        emit_uv=emit_uv, t_cap_frac=cut_frac, cull=cull, per_ray=per_ray,
        proxy=proxy,
    )

    sel, cap_rows, n_stragglers = twopass_stragglers(
        scene, hit1.t, count, dist, cut_frac, cap_frac, tp, tf, er)
    if profiling.recording():
        rays = profiling.counter("twopass.rays")
        rays["pass1"] += tp * r
        rays["stragglers"] += n_stragglers
    with profiling.span("twopass.retrace"):
        cap_rays = cap_rows * r
        if n_stragglers > cap_rays:  # one device-to-host sync per call
            counts["overflows"] += 1
            h = cast_fans_culled(
                scene, o_rows, d, t_min=t_min, fan_block=tf,
                exit_rows=exit_rows, emit_uv=emit_uv, per_ray=per_ray,
                proxy=proxy, occluders=occluders,
            )
            return RayHit(t=h.t[:tp], prim=h.prim[:tp], u=h.u[:tp],
                          v=h.v[:tp])

        d2 = tuple(a.reshape(-1)[sel].reshape(cap_rows, r) for a in d)
        if per_ray:
            o2 = tuple(a.reshape(-1)[sel].reshape(cap_rows, r)
                       for a in o_rows)
        else:
            o2 = tuple(a[sel // r].reshape(cap_rows, r) for a in o_rows)
        if cut_frac2 is not None:
            hit2 = cast_fans_culled_twopass(
                scene, o2, d2, t_min=t_min, fan_block=tf,
                exit_rows=exit_rows, emit_uv=emit_uv, per_ray=True,
                proxy=proxy, cut_frac=cut_frac2, cap_frac=cap_frac2,
                occluders=occluders,
            )
        else:
            hit2 = cast_fans_culled(
                scene, o2, d2, t_min=t_min, fan_block=tf,
                exit_rows=exit_rows, emit_uv=emit_uv, per_ray=True,
                proxy=proxy, occluders=occluders,
            )

        # re-traced final rays that fill the capacity come out unchanged,
        # so all cap_rays slots scatter back
        def put(a1, a2):
            out = a1.reshape(-1).clone()
            out[sel] = a2.reshape(-1)
            return out.reshape(tpad, r)[:tp]

        return RayHit(t=put(hit1.t, hit2.t), prim=put(hit1.prim, hit2.prim),
                      u=put(hit1.u, hit2.u), v=put(hit1.v, hit2.v))


# calls and overflows (full-trace branch) since the last .clear()
cast_fans_culled_twopass.counts = profiling.counter("twopass")
