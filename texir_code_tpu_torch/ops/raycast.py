"""Ray casting: the skip-link BVH traversal, the ray-hit contract, SoA
vector helpers and the brute-force oracle.

Layout: the hot path is SoA — per-component tensors (ox, oy, oz, ...)
instead of [B, 3] — as in the JAX package, so every function of the port
keeps the reference's signatures.

Contract (matches `o3d.t.geometry.RaycastingScene.cast_rays`):

    RayHit(t, prim, u, v)
      t    : hit distance, +inf on miss
      prim : original face index (primitive_ids), -1 on miss
      u, v : barycentric coords of corners 1 and 2 (primitive_uvs):
             hit_point = (1-u-v)·p0 + u·p1 + v·p2

`cast_rays_soa` is the JAX package's stackless traversal in plain
PyTorch: one node index per ray, advanced by skip links (geometry/bvh.py
has the layout), one row gather per visited node, the slab test, the
leaf's Möller–Trumbore tests in the reference's operation order, and the
first triangle winning an exact-t tie.  No backface culling.  XLA runs the
JAX loop as one device program; here every iteration is a few dozen
launches, so the host reads the loop's condition only every
`check_every` iterations (an extra iteration changes no finished ray) and
then drops the finished rays from the working set (bit-equal to running
them).  `cast_rays` is the AoS wrapper; `cast_rays_brute` is the
all-triangles correctness oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DET_EPS = 1e-12
_BARY_EPS = 1e-7

Vec3s = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def to_soa(x: torch.Tensor) -> Vec3s:
    """[..., 3] → three [...] component tensors."""
    return (x[..., 0], x[..., 1], x[..., 2])


def from_soa(v: Vec3s) -> torch.Tensor:
    return torch.stack(v, dim=-1)


def soa_dot(a: Vec3s, b: Vec3s) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def soa_cross(a: Vec3s, b: Vec3s) -> Vec3s:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def soa_sub(a: Vec3s, b: Vec3s) -> Vec3s:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def soa_scale(a: Vec3s, s: torch.Tensor) -> Vec3s:
    return (a[0] * s, a[1] * s, a[2] * s)


def soa_add(a: Vec3s, b: Vec3s) -> Vec3s:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def soa_normalize(a: Vec3s, eps: float = 0.0) -> Vec3s:
    inv = torch.rsqrt(soa_dot(a, a) + 1e-20)
    if eps:
        n = torch.sqrt(soa_dot(a, a))
        inv = 1.0 / (n + eps)
    return soa_scale(a, inv)


@dataclasses.dataclass
class DeviceBVH:
    """FlatBVH packed for traversal on a device: `packed` is the [N, 48]
    supernode table (FlatBVH.pack_supernodes: AABB, skip link, leaf count,
    and for leaves the prim ids and all leaf_width triangles, ints
    bitcast), so a visit is one row gather."""

    packed: torch.Tensor  # [N, 8 + 10·leaf_width] float32
    leaf_width: int

    @classmethod
    def from_flat(cls, bvh, device="cuda") -> "DeviceBVH":
        from texir_code_tpu_torch.device import resolve_device

        return cls(
            packed=torch.from_numpy(bvh.pack_supernodes()).to(
                resolve_device(device)),
            leaf_width=bvh.leaf_width,
        )


@dataclasses.dataclass
class RayHit:
    t: torch.Tensor     # float32, +inf on miss
    prim: torch.Tensor  # int32, -1 on miss
    u: torch.Tensor     # float32 barycentric (corner 1)
    v: torch.Tensor     # float32 barycentric (corner 2)


def _moller_trumbore_soa(
    o: Vec3s, d: Vec3s, p0: Vec3s, e1: Vec3s, e2: Vec3s, t_min: float
):
    """Batched ray/triangle intersection in SoA. Returns (hit, t, u, v)."""
    pvec = soa_cross(d, e2)
    det = soa_dot(e1, pvec)
    ok_det = torch.abs(det) > _DET_EPS
    inv_det = torch.where(
        ok_det, 1.0 / torch.where(det == 0, torch.ones_like(det), det),
        torch.zeros_like(det),
    )
    tvec = soa_sub(o, p0)
    u = soa_dot(tvec, pvec) * inv_det
    qvec = soa_cross(tvec, e1)
    v = soa_dot(d, qvec) * inv_det
    t = soa_dot(e2, qvec) * inv_det
    hit = (
        ok_det
        & (u >= -_BARY_EPS)
        & (v >= -_BARY_EPS)
        & (u + v <= 1.0 + _BARY_EPS)
        & (t > t_min)
    )
    return hit, t, u, v


def cast_rays_brute(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    t_min: float = 0.0,
    chunk: int = 512,
) -> RayHit:
    """O(B·F) reference intersector (correctness oracle; small scenes only).

    origins/dirs [B, 3]; scans triangle chunks to bound memory at B×chunk.
    Within a chunk the first minimal t wins; across chunks a later chunk
    replaces the best only when strictly closer."""
    tri = vertices[faces.long()]  # [F, 3, 3]
    p0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    f = faces.shape[0]
    b = origins.shape[0]
    dev = origins.device
    o = to_soa(origins[:, None, :])
    d = to_soa(dirs[:, None, :])
    t_best = torch.full((b,), float("inf"), dtype=torch.float32, device=dev)
    prim = torch.full((b,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros((b,), dtype=torch.float32, device=dev)
    v_best = torch.zeros((b,), dtype=torch.float32, device=dev)
    for sl in range(0, f, chunk):
        cp0 = to_soa(p0[None, sl:sl + chunk])
        ce1 = to_soa(e1[None, sl:sl + chunk])
        ce2 = to_soa(e2[None, sl:sl + chunk])
        hit, t, u, v = _moller_trumbore_soa(o, d, cp0, ce1, ce2, t_min)
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        best = torch.argmin(t, dim=1, keepdim=True)
        bt = torch.gather(t, 1, best)[:, 0]
        closer = bt < t_best
        t_best = torch.where(closer, bt, t_best)
        prim = torch.where(closer, (sl + best[:, 0]).to(torch.int32), prim)
        u_best = torch.where(closer, torch.gather(u, 1, best)[:, 0], u_best)
        v_best = torch.where(closer, torch.gather(v, 1, best)[:, 0], v_best)
    return RayHit(t=t_best, prim=prim, u=u_best, v=v_best)


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1/d with near-zero components mapped to a huge finite value, so the
    slab test stays NaN-free: a slab holding the origin on a degenerate
    axis gives (-huge, +huge) and passes; one strictly to a side misses."""
    ok = torch.abs(d) > 1e-12
    return torch.where(ok, 1.0 / torch.where(ok, d, torch.ones_like(d)),
                       torch.full_like(d, 1e30))


def _slab_test_soa(o: Vec3s, inv_d: Vec3s, bmin: Vec3s, bmax: Vec3s,
                   t_best: torch.Tensor, t_min: float) -> torch.Tensor:
    tnear = torch.full_like(t_best, -float("inf"))
    tfar = torch.full_like(t_best, float("inf"))
    for k in range(3):
        t0 = (bmin[k] - o[k]) * inv_d[k]
        t1 = (bmax[k] - o[k]) * inv_d[k]
        tnear = torch.maximum(tnear, torch.minimum(t0, t1))
        tfar = torch.minimum(tfar, torch.maximum(t0, t1))
    return (tnear <= tfar) & (tfar >= t_min) & (tnear <= t_best)


def _traverse_step(packed, lw: int, o: Vec3s, d: Vec3s, inv_d: Vec3s,
                   state, t_min: float):
    """One iteration of the JAX loop body on the working set.  The leaf's
    triangles are tested at once, each in the reference's operation
    order; the smallest accepted t (the first on a tie, as torch.min
    returns it) replaces the best only when strictly closer — what the
    reference's sequential `closer = hit & valid & (t < t_best)` keeps."""
    node, t_best, prim, u_best, v_best = state
    active = node >= 0
    nidx = torch.where(active, node, torch.zeros_like(node))
    row = packed[nidx]                                   # [B, 8 + 10·lw]
    irow = row.view(torch.int32)
    bmin = (row[:, 0], row[:, 1], row[:, 2])
    bmax = (row[:, 3], row[:, 4], row[:, 5])
    miss, lc = irow[:, 6], irow[:, 7]
    hit_box = _slab_test_soa(o, inv_d, bmin, bmax, t_best, t_min) & active
    is_leaf = lc > 0
    do_leaf = hit_box & is_leaf

    tri = row[:, 8 + lw:8 + 10 * lw].reshape(-1, lw, 9)
    p0 = (tri[..., 0], tri[..., 1], tri[..., 2])
    e1 = (tri[..., 3], tri[..., 4], tri[..., 5])
    e2 = (tri[..., 6], tri[..., 7], tri[..., 8])
    oo = tuple(c[:, None] for c in o)
    dd = tuple(c[:, None] for c in d)
    hit, t, u, v = _moller_trumbore_soa(oo, dd, p0, e1, e2, t_min)
    j = torch.arange(lw, device=row.device)
    ok = hit & do_leaf[:, None] & (j[None, :] < lc[:, None])
    t_j, k = torch.min(torch.where(ok, t, torch.full_like(t, float("inf"))),
                       dim=1)
    closer = t_j < t_best
    kk = k[:, None]
    t_best = torch.where(closer, t_j, t_best)
    prim = torch.where(closer,
                       torch.gather(irow[:, 8:8 + lw], 1, kk)[:, 0], prim)
    u_best = torch.where(closer, torch.gather(u, 1, kk)[:, 0], u_best)
    v_best = torch.where(closer, torch.gather(v, 1, kk)[:, 0], v_best)

    nxt = torch.where(hit_box & ~is_leaf, nidx + 1, miss)
    node = torch.where(active, nxt, torch.full_like(nxt, -1))
    return node, t_best, prim, u_best, v_best


def cast_rays_soa(
    bvh: DeviceBVH,
    origins: Vec3s,
    dirs: Vec3s,
    t_min: float = 0.0,
    max_iters: int = 0,
    check_every: int = 8,
    compact: bool = True,
) -> RayHit:
    """Trace rays (SoA components of any equal shape) against the BVH.

    Args:
        origins / dirs: 3-tuples of same-shape float32 tensors on the BVH's
            device (dirs need not be normalized; t is in units of |dir|).
        t_min: minimum hit distance.
        max_iters: traversal bound (0 = until every ray terminates); the
            loop then runs min(needed, max_iters) iterations, as JAX's.
        check_every: iterations between host reads of the loop condition
            (`any(node >= 0)`); the extra iterations after the last ray
            finishes leave every hit as it is.
        compact: at each check, drop the finished rays from the working set
            once they are at least half of it (outputs bit-equal).
    Returns:
        RayHit shaped like origins[0].  `cast_rays_soa.stats` holds the
        last call's iterations, host syncs and working-set compactions.
    """
    shape = origins[0].shape
    o = tuple(c.reshape(-1) for c in origins)
    d = tuple(c.reshape(-1) for c in dirs)
    b = o[0].shape[0]
    dev = o[0].device
    inv_d = tuple(_safe_inv(c) for c in d)
    out = [
        torch.zeros(b, dtype=torch.int32, device=dev),            # node
        torch.full((b,), float("inf"), dtype=torch.float32, device=dev),
        torch.full((b,), -1, dtype=torch.int32, device=dev),
        torch.zeros(b, dtype=torch.float32, device=dev),
        torch.zeros(b, dtype=torch.float32, device=dev),
    ]
    state = tuple(out)
    idx = None  # working set: every ray, until the first compaction
    it = syncs = compactions = 0
    lw = bvh.leaf_width
    while b:
        k = check_every if not max_iters else min(check_every, max_iters - it)
        if k <= 0:
            break
        for _ in range(k):
            state = _traverse_step(bvh.packed, lw, o, d, inv_d, state, t_min)
        it += k
        alive = state[0] >= 0
        n_alive = int(alive.sum())  # the loop's one host sync
        syncs += 1
        if n_alive == 0:
            break
        if compact and 2 * n_alive <= alive.shape[0]:
            keep = torch.nonzero(alive).reshape(-1)
            if idx is None:
                out = list(state)
                idx = keep
            else:
                for a, s in zip(out, state):
                    a[idx] = s
                idx = idx[keep]
            state = tuple(s[keep] for s in state)
            o, d, inv_d = (tuple(c[keep] for c in x) for x in (o, d, inv_d))
            compactions += 1
    if idx is None:
        out = list(state)
    else:
        for a, s in zip(out, state):
            a[idx] = s
    cast_rays_soa.stats = dict(iterations=it, syncs=syncs,
                               compactions=compactions)
    _, t, prim, u, v = out
    return RayHit(t=t.reshape(shape), prim=prim.reshape(shape),
                  u=u.reshape(shape), v=v.reshape(shape))


cast_rays_soa.stats = dict(iterations=0, syncs=0, compactions=0)


def cast_rays(bvh: DeviceBVH, origins: torch.Tensor, dirs: torch.Tensor,
              t_min: float = 0.0, max_iters: int = 0) -> RayHit:
    """AoS convenience wrapper: origins/dirs [B, 3]."""
    return cast_rays_soa(bvh, to_soa(origins), to_soa(dirs), t_min, max_iters)
