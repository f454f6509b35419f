"""Culled cluster walk — closest hits sub-linear in scene size.

The port of the JAX package's `ops/pallas_culled.py` (the unseeded walk:
the bake's shared-origin wedge rows, the G-buffer's pixel rows and the
specular trace's per-ray rows):

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
     PyTorch with the TPU kernel's group-wide exit.

Results are exact: every cluster that could hold a closer hit lies in the
visited prefix.  Leaf rows reuse the FanScene plane-dual layout
(ops.fan_raycast), re-packed cluster-major [C, LB, 128]; the packing is
numpy and equal, array for array, to the JAX package's.

The file keeps the JAX module's name so each counterpart is easy to find;
nothing in it is Pallas.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.ops.fan_raycast import (
    FAN_ROW_WIDTH_UV,
    _TRI_BASE,
    _TRI_STRIDE,
    _UV_BASE,
    FanScene,
)
from texir_code_tpu_torch.ops.raycast import RayHit, Vec3s

_DET_EPS = 1e-12
_BARY_EPS = 1e-7
_ROW_PAD = 128          # cluster rows padded to 128 columns
_PRIM_ROWS = 8          # prims3 is [C, 8, 128] int32, as the JAX package's

# modes of the TPU kernel that are not ported yet (ROADMAP.md, queue B,
# item B1 order (d)-(e))
_TODO_B1 = "ROADMAP.md queue B, B1 (seeded and debug modes)"


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
    through one are removed — exactly (see geometry.occluders)."""
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
    emit_prim: bool = True, per_ray: bool = False,
):
    """The walk in plain PyTorch: the CPU path and the kernel's oracle.

    Same arguments and results as `culled_walk`.  Vectorised over all exit
    groups, it loops over candidate index j and keeps the TPU kernel's
    group-wide exit: a group is live while j < count and the next bound is
    below min(max t_best over the group, t_cap), its threshold refreshed
    after each visit.  Only live groups are gathered and tested."""
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
    t_best = torch.full(shape, float("inf"), device=dev)
    prim = torch.full(shape, -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(shape, device=dev)
    v_best = torch.zeros(shape, device=dev)
    thr = torch.full((g,), float("inf"), device=dev)
    live = torch.ones((g,), dtype=torch.bool, device=dev)
    count = count.long()
    for j in range(c):
        live &= (j < count) & (dist[:, j] < torch.clamp_max(thr, t_cap))
        idx = torch.nonzero(live).squeeze(1)
        if idx.numel() == 0:
            break
        cid = cand[idx, j].long()
        rows = rows3[cid]  # [n, lb, 128]
        pids = prims3[cid].reshape(len(cid), -1) if emit_prim else None
        ox, oy, oz = (a[idx] for a in o)
        ddx, ddy, ddz = (a[idx] for a in d)
        tb, pb, ub, vb = t_best[idx], prim[idx], u_best[idx], v_best[idx]
        for jr in range(lb):
            for tri in range(4):
                base = _TRI_BASE + _TRI_STRIDE * tri

                def col(k, jr=jr):
                    return rows[:, jr, k].reshape(-1, 1, 1)

                nx, ny, nz, pd = (col(base + k) for k in range(4))
                s1x, s1y, s1z, p0s1 = (col(base + 4 + k) for k in range(4))
                s2x, s2y, s2z, p0s2 = (col(base + 8 + k) for k in range(4))
                no = nx * ox + ny * oy + nz * oz
                ou = s1x * ox + s1y * oy + s1z * oz - p0s1
                ov = s2x * ox + s2y * oy + s2z * oz - p0s2
                nd = nx * ddx + ny * ddy + nz * ddz
                # |nd| <= eps is rejected below; inf/nan there compare False
                inv_nd = 1.0 / nd
                t = (pd - no) * inv_nd
                du = s1x * ddx + s1y * ddy + s1z * ddz
                dv = s2x * ddx + s2y * ddy + s2z * ddz
                uu = ou + t * du
                vv = ov + t * dv
                ok = (
                    (torch.abs(nd) > _DET_EPS)
                    & (torch.minimum(uu, vv) >= -_BARY_EPS)
                    & (uu + vv <= 1.0 + _BARY_EPS)
                    & (t > t_min)
                    & (t < tb)
                )
                tb = torch.where(ok, t, tb)
                if emit_prim:
                    pid = pids[:, 4 * jr + tri].reshape(-1, 1, 1)
                    pb = torch.where(ok, pid, pb)
                if emit_uv:
                    ubase = _UV_BASE + 6 * tri
                    au = col(ubase) + uu * col(ubase + 1) + vv * col(ubase + 2)
                    av = (col(ubase + 3) + uu * col(ubase + 4)
                          + vv * col(ubase + 5))
                    ub = torch.where(ok, au, ub)
                    vb = torch.where(ok, av, vb)
                else:
                    ub = torch.where(ok, uu, ub)
                    vb = torch.where(ok, vv, vb)
        t_best[idx], prim[idx], u_best[idx], v_best[idx] = tb, pb, ub, vb
        thr[idx] = tb.amax(dim=(1, 2))
    return tuple(
        a.reshape(n_rows, r) for a in (t_best, prim, u_best, v_best)
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
                       i, p, p, p, p, p]
    return lib


def walk_mode(per_ray: bool, emit_uv: bool, emit_prim: bool) -> str:
    """Name of a kernel mode, as `culled_walk_cuda.launches` counts it:
    'shared' or 'per_ray' origins, then '_uv' and/or '_prim' outputs (the
    bake runs 'shared_uv', the G-buffer 'shared_prim', the specular trace
    'per_ray_uv')."""
    name = "per_ray" if per_ray else "shared"
    return name + ("_uv" if emit_uv else "") + ("_prim" if emit_prim else "")


def culled_walk_cuda(
    count, cand, dist, t_cap: float, origins, dx, dy, dz, rows3, prims3,
    er: int, t_min: float = 0.0, emit_uv: bool = False,
    emit_prim: bool = True, per_ray: bool = False,
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
    if rows3.data_ptr() % 16:
        raise ValueError("rows3 must be 16-byte aligned")
    if lb * (_ROW_PAD + 4) * 4 > _SMEM_LIMIT:
        raise ValueError(f"cluster size lb={lb} exceeds shared memory")
    if er * r > 65535 * 256:
        raise ValueError(f"exit group of {er}x{r} rays is too large")
    shape = (n_rows, r)
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    prim = torch.empty(shape, dtype=torch.int32, device=dev)
    u = torch.empty(shape, dtype=torch.float32, device=dev)
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _culled_walk_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.texir_culled_walk(
            count.data_ptr(), cand.data_ptr(), dist.data_ptr(), g, c,
            float(t_cap), float(t_min), origins.data_ptr(), dx.data_ptr(),
            dy.data_ptr(), dz.data_ptr(), r, er, rows3.data_ptr(),
            prims3.data_ptr(), lb, int(per_ray), int(emit_uv),
            int(emit_prim), t.data_ptr(), prim.data_ptr(), u.data_ptr(),
            v.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"culled_walk launch failed: cudaError {err}")
    culled_walk_cuda.launches[walk_mode(per_ray, emit_uv, emit_prim)] += 1
    return t, prim, u, v


# launches per kernel mode (walk_mode); callers reset it with .clear()
culled_walk_cuda.launches = collections.Counter()


def culled_walk(
    count, cand, dist, t_cap: float, origins, dx, dy, dz, rows3, prims3,
    er: int, t_min: float = 0.0, emit_uv: bool = False,
    emit_prim: bool = True, per_ray: bool = False,
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
    Returns:
        (t, prim, u, v), each [G*er, R]: t = +inf and prim = -1 on miss;
        prim is -1 throughout unless emit_prim; (u, v) are barycentrics,
        or the atlas uv of the hit with emit_uv.

    On CUDA tensors this launches the CUDA kernel (culled_walk_cuda); on
    CPU tensors it runs culled_walk_plain."""
    args = (count, cand, dist, t_cap, origins, dx, dy, dz, rows3, prims3, er,
            t_min, emit_uv, emit_prim, per_ray)
    if dx.device.type == "cuda":
        return culled_walk_cuda(*args)
    if dx.device.type == "cpu":
        return culled_walk_plain(*args)
    raise ValueError(f"culled_walk: unsupported device {dx.device}")


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
            hits with t <= t_cap_frac·diameter are exact.
        occluders: optional OccluderSet for exact PVS culling.
        stream_cands: accepted for signature parity; on the GPU the
            candidate tables live in device memory anyway, so it changes
            nothing.
        seed / proxy / debug_emit_visits: not ported yet.
    Returns:
        RayHit of shape [T', R] — exact closest hits (when t_cap_frac
        covers the scene).
    """
    del stream_cands  # no shared-memory table limit to stream around
    if seed is not None or proxy is not None or debug_emit_visits:
        raise NotImplementedError(
            f"cast_fans_culled: seed/proxy/debug_emit_visits are not ported "
            f"yet ({_TODO_B1})"
        )
    tp, r = dirs[0].shape
    tf = fan_block
    t_pad = (-tp) % tf
    o_rows, d = tuple(origins), tuple(dirs)
    if t_pad:
        pad_o = (0, 0, 0, t_pad) if per_ray else (0, t_pad)
        o_rows = tuple(torch.nn.functional.pad(a, pad_o) for a in o_rows)
        d = tuple(torch.nn.functional.pad(a, (0, 0, 0, t_pad)) for a in d)
    if per_ray:
        # the groups' origin boxes widen by each row's spread (conservative)
        cull_lo = tuple(a.amin(dim=1) for a in o_rows)
        cull_hi = tuple(a.amax(dim=1) for a in o_rows)
        o_pack = torch.stack(o_rows, dim=0).contiguous()  # [3, T', R]
    else:
        cull_lo = cull_hi = o_rows
        o_pack = torch.stack(o_rows, dim=-1).contiguous()  # [T', 3]
    er = exit_rows if (exit_rows and tf % exit_rows == 0) else tf
    cand, count, dist = cull_blocks(
        scene, cull_lo, cull_hi, d, er, occluders=occluders
    )
    g = (tp + t_pad) // er
    cc = scene.num_clusters
    if emit_prim is None:
        emit_prim = not emit_uv
    # exit threshold cap = scene diameter (+ margin for surface-eps offset
    # origins): no real hit can be farther, so miss rays can't pin the exit
    cap_frac = 1.05 if t_cap_frac is None else t_cap_frac
    t_cap = float(np.float32(cap_frac) * np.float32(scene.diameter))
    t, prim, u, v = culled_walk(
        count.reshape(g).contiguous(), cand.reshape(g, cc).contiguous(),
        dist.reshape(g, cc).contiguous(), t_cap, o_pack,
        *(a.contiguous() for a in d), scene.rows3, scene.prims3, er,
        t_min=t_min, emit_uv=emit_uv, emit_prim=emit_prim, per_ray=per_ray,
    )
    return RayHit(t=t[:tp], prim=prim[:tp], u=u[:tp], v=v[:tp])
