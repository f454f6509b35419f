"""Plane-dual leaf rows for shared-origin ray fans (host-side packing).

With a shared origin the Möller–Trumbore chain collapses: precompute per
triangle the plane (n, dist = n·p0) and the barycentric dual vectors
s1 = (e2 × n)/|n|², s2 = (n × e1)/|n|², so that for a ray o + t·d:

    t = (dist − n·o) / (n·d)
    u = (o − p0)·s1 + t·(d·s1)
    v = (o − p0)·s2 + t·(d·s2)

`FanScene.from_flat` packs a FlatBVH's leaves into such rows; the culled
cluster walk (ops.pallas_culled) re-packs them cluster-major, and the
exhaustive stream (ops.pallas_fan) reads them as they are
(`FanScene.device_rows`) and, in its CUDA kernel, as packed triangle
records (`pack_records`, `FanScene.device_records`).  The row packing is
numpy and equal, array for array, to the JAX package's.
`closest_hit_block` is the test of a block of these triangles in plain
PyTorch, the inner loop of both kernels' plain versions.

`cast_ray_fans` is the JAX package's leaf-budgeted fan trace in plain
PyTorch (XLA runs it there, outside any Pallas kernel): a dense fan × leaf
cull (swept point-beam and front half-space, optionally the fan's tangent
plane), each fan's first K overlapping leaves in row order, a loop over
those K leaves, and per-fan overflow flags where more than K leaves
overlap.  `cast_ray_fans_exact` re-traces the overflowing fans with the
BVH (ops.raycast.cast_rays_soa).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from texir_code_tpu_torch import profiling
from texir_code_tpu_torch.geometry.bvh import FlatBVH
from texir_code_tpu_torch.ops.raycast import RayHit, cast_rays_soa

# per-leaf row: aabb(6) count(1) pad(1) prim(4) + 4 × [n(3) dist(1) s1(3)
# p0s1(1) s2(3) p0s2(1) p0(3)] = 8 + 4 + 4*15 = 72.  With texture uvs
# (FanScene.from_flat(..., triangle_uvs=...)) each tri appends
# (tu0, du1, du2, tv0, dv1, dv2) at 72 + 6*tri → width 96.
FAN_ROW_WIDTH = 72
FAN_ROW_WIDTH_UV = 96
_TRI_BASE = 12
_TRI_STRIDE = 15
_UV_BASE = 72


@dataclasses.dataclass
class FanScene:
    """Leaf rows with plane-dual triangle data (host numpy)."""

    rows: np.ndarray  # [L, 72 | 96] float32 (prim ids as float bit patterns)
    diameter: float   # scene AABB diagonal, rounded to float32
    # the rows as a tensor per device, uploaded once (device_rows), and
    # their packed triangle records (device_records)
    _device_rows: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _device_records: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def num_leaves(self) -> int:
        return int(self.rows.shape[0])

    def device_rows(self, device) -> torch.Tensor:
        """The rows as a float32 tensor on `device`, copied there on the
        first call and cached: the exhaustive stream
        (ops.pallas_fan) reads them on every call."""
        dev = torch.device(device)
        rows = self._device_rows.get(dev)
        if rows is None:
            rows = torch.from_numpy(self.rows).to(dev).contiguous()
            self._device_rows[dev] = rows
        return rows

    def device_records(self, device):
        """pack_records of the rows on `device`, packed on the first call
        and cached: the CUDA stream kernel reads them on every call."""
        dev = torch.device(device)
        rec = self._device_records.get(dev)
        if rec is None:
            rec = pack_records(self.device_rows(dev))
            self._device_records[dev] = rec
        return rec

    @classmethod
    @profiling.timed("pack", "fan")
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


def pack_records(rows: torch.Tensor):
    """The triangles of FanScene rows as the stream kernel reads them
    (csrc/fan_stream.cu): (records [K, 12] float32, slots [K] int32).

    A record is a triangle's tested words (n, dist, s1, p0s1, s2, p0s2),
    rows[row, 12 + 15·tri : 24 + 15·tri], and its slot is row·4 + tri; the
    records keep row order and leave out every slot whose normal is zero
    (padding, or a degenerate triangle: n·d = 0, so it never hits)."""
    n = rows.shape[0]
    tri = rows[:, _TRI_BASE:_TRI_BASE + 4 * _TRI_STRIDE].reshape(
        4 * n, _TRI_STRIDE)[:, :12]
    real = (tri[:, 0:3] != 0).any(dim=1)
    slots = torch.nonzero(real).reshape(-1).to(torch.int32)
    return tri[real].contiguous(), slots


_DET_EPS = 1e-12
_BARY_EPS = 1e-7


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


def cast_ray_fans(scene: FanScene, origins, dirs, t_min: float = 0.0,
                  max_leaves: int = 512, return_overflow: bool = False,
                  fan_normals=None):
    """Closest-hit trace of T fans × R rays sharing per-fan origins.

    Args:
        scene: FanScene (its rows go to the rays' device once).
        origins: 3-tuple of [T] per-fan origins.
        dirs: 3-tuple of [T, R] directions.
        t_min: minimum hit distance.
        max_leaves: per-fan candidate-leaf budget K; a fan whose cull keeps
            more leaves is flagged (return_overflow) and traced over its
            first K only.
        fan_normals: optional 3-tuple of [T] hemisphere axes; leaves wholly
            behind a fan's tangent plane are culled (exact when every
            direction of the fan has n·d ≥ 0, as a bake texel's).
    Returns:
        RayHit of [T, R] (+ [T, R] overflow flags if requested).
    """
    t_fans, r = dirs[0].shape
    dev = dirs[0].device
    rows = scene.device_rows(dev)
    l = rows.shape[0]
    diam = float(scene.diameter)

    # dense fan × leaf culling (swept point-beam + front half-space)
    dmin = tuple(torch.amin(dirs[k], dim=1) for k in range(3))
    dmax = tuple(torch.amax(dirs[k], dim=1) for k in range(3))
    overlap = torch.ones((t_fans, l), dtype=torch.bool, device=dev)
    front = torch.zeros((t_fans, l), dtype=torch.float32, device=dev)
    for k in range(3):
        lo_k = origins[k] + diam * torch.clamp_max(dmin[k], 0.0)
        hi_k = origins[k] + diam * torch.clamp_min(dmax[k], 0.0)
        overlap &= rows[None, :, k] <= hi_k[:, None]
        overlap &= rows[None, :, 3 + k] >= lo_k[:, None]
        r_lo = rows[None, :, k] - origins[k][:, None]
        r_hi = rows[None, :, 3 + k] - origins[k][:, None]
        cand = torch.maximum(
            torch.maximum(r_lo * dmin[k][:, None], r_lo * dmax[k][:, None]),
            torch.maximum(r_hi * dmin[k][:, None], r_hi * dmax[k][:, None]),
        )
        front = front + cand
    overlap &= front >= 0.0
    if fan_normals is not None:
        # a leaf is reachable only if some AABB corner is on the hemisphere
        # side: max over corners of (c - o)·n ≥ 0, separable per axis
        plane = torch.zeros((t_fans, l), dtype=torch.float32, device=dev)
        for k in range(3):
            nk = fan_normals[k][:, None]
            r_lo = rows[None, :, k] - origins[k][:, None]
            r_hi = rows[None, :, 3 + k] - origins[k][:, None]
            plane = plane + torch.maximum(r_lo * nk, r_hi * nk)
        overlap &= plane >= 0.0

    # lax.top_k of the 0/1 scores: the overlapping leaves first, each group
    # in row order (a stable sort)
    kk = min(max_leaves, l)
    order = torch.sort(overlap.to(torch.int8), dim=1, descending=True,
                       stable=True)
    leaf_ids = order.indices[:, :kk]
    valid_leaf = order.values[:, :kk] > 0
    counts = overlap.sum(dim=1)

    # the leaf loop: each fan's k-th leaf is a block of 4 triangles; a
    # triangle that the reference masks (invalid leaf, slot ≥ count) gets
    # a zero normal, so it is never accepted (|n·d| = 0)
    irows = rows.view(torch.int32)
    jj = torch.arange(4, device=dev)
    o3 = tuple(c.reshape(t_fans, 1, 1) for c in origins)
    d3 = tuple(c.reshape(t_fans, 1, r) for c in dirs)
    hit = (torch.full((t_fans, 1, r), float("inf"), device=dev),
           torch.full((t_fans, 1, r), -1, dtype=torch.int32, device=dev),
           torch.zeros((t_fans, 1, r), device=dev),
           torch.zeros((t_fans, 1, r), device=dev))
    for k_idx in range(kk):
        ids = leaf_ids[:, k_idx]
        row = rows[ids]
        lc = irows[ids, 6]
        tri = row[:, _TRI_BASE:_TRI_BASE + 4 * _TRI_STRIDE].reshape(
            t_fans, 4, _TRI_STRIDE)
        use = valid_leaf[:, k_idx, None] & (jj[None, :] < lc[:, None])
        tri = torch.cat([tri[..., :3] * use[..., None], tri[..., 3:]],
                        dim=-1)
        hit = closest_hit_block(tri, None, irows[ids, 8:12], o3, d3, hit,
                                t_min, emit_uv=False)
    t_best, prim, u_best, v_best = (a.reshape(t_fans, r) for a in hit)
    out = RayHit(t=t_best, prim=prim, u=u_best, v=v_best)
    if not return_overflow:
        return out
    over = (counts > kk)[:, None].expand(t_fans, r)
    return out, over


def cast_ray_fans_exact(scene: FanScene, bvh, origins, dirs,
                        t_min: float = 0.0, max_leaves: int = 512,
                        fan_normals=None) -> RayHit:
    """Fan trace (cast_ray_fans) with the fans that overflow their leaf
    budget re-traced exactly by the BVH traversal (one host sync a call).

    Args:
        bvh: ops.raycast.DeviceBVH of the same mesh.
        the rest: as cast_ray_fans.
    """
    hit, over = cast_ray_fans(scene, origins, dirs, t_min=t_min,
                              max_leaves=max_leaves, return_overflow=True,
                              fan_normals=fan_normals)
    idx = torch.nonzero(over[:, 0]).reshape(-1)
    if idx.numel() == 0:
        return hit
    t_fans, r = dirs[0].shape
    # the traversal gathers a row per ray and visit: bound a chunk's rays
    chunk = max(1, (1 << 20) // r)
    t_out, p_out, u_out, v_out = (a.clone() for a in
                                  (hit.t, hit.prim, hit.u, hit.v))
    for s in range(0, idx.numel(), chunk):
        ii = idx[s:s + chunk]
        m = ii.numel()
        sub = cast_rays_soa(
            bvh, tuple(origins[k][ii][:, None].expand(m, r)
                       for k in range(3)),
            tuple(dirs[k][ii] for k in range(3)), t_min=t_min)
        t_out[ii] = sub.t
        p_out[ii] = sub.prim
        u_out[ii] = sub.u
        v_out[ii] = sub.v
    return RayHit(t=t_out, prim=p_out, u=u_out, v=v_out)
