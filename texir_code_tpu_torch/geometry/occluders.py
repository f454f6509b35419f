"""Proven rectangular occluders — host-side PVS precompute for the culled
cluster walk.

Clusters behind a wall are geometrically close, so distance bounds alone
keep them in every candidate list.  This module proves axis-aligned
rectangles fully covered by mesh triangles (`extract_occluders`, host numpy,
a copy of the JAX package's extraction) and removes, per exit group, the
clusters every ray of the group would reach only through such a rectangle
(`occluder_plane_bounds` / `occluder_blocked_clusters`, PyTorch, called
from ops.pallas_culled.cull_blocks).  Culling those clusters is exact: any
ray that could reach one records a strictly closer hit on the occluder
first.  See the JAX package's geometry/occluders.py for the full argument.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from texir_code_tpu_torch import profiling
from texir_code_tpu_torch.device import resolve_device

# direction-cone minimum toward-plane component for a blocker to engage:
# crossing-point intervals scale with 1/d_k, so near-tangent cones have
# unbounded crossings and can never be proven inside a rectangle anyway
_D_MIN = 1e-4


@dataclasses.dataclass
class OccluderSet:
    """K proven rectangular occluders.

    Attributes:
        axis: length-K tuple of ints — plane normal axis k.
        p: [K] float32 tensor — plane offset (x_k = p).
        rect_lo / rect_hi: [K, 2] float32 tensors — rectangle bounds in the
            two other axes, ordered ((k+1)%3, (k+2)%3), pre-shrunk by the
            extraction safety margin.
        sep_margin: float (a float32 value) — minimum origin-box/plane
            separation for the blocking test.
        axis_index: [K] int64 tensor of `axis` on the device of `p`
            (derived), so the blocking test copies nothing from the host.
    """

    axis: tuple
    p: torch.Tensor
    rect_lo: torch.Tensor
    rect_hi: torch.Tensor
    sep_margin: float
    axis_index: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.axis_index = torch.tensor(
            self.axis, dtype=torch.long, device=self.p.device
        )

    @property
    def num_occluders(self) -> int:
        return len(self.axis)


# ---------------------------------------------------------------------------
# extraction (host-side numpy)
# ---------------------------------------------------------------------------


def _clip_poly_to_box(poly: np.ndarray, lo, hi) -> np.ndarray:
    """Sutherland–Hodgman clip of convex polygon [n, 2] to an axis box."""
    def clip_half(pts, axis, bound, keep_leq):
        if len(pts) == 0:
            return pts
        out = []
        n = len(pts)
        for i in range(n):
            a = pts[i]
            b = pts[(i + 1) % n]
            ina = (a[axis] <= bound) if keep_leq else (a[axis] >= bound)
            inb = (b[axis] <= bound) if keep_leq else (b[axis] >= bound)
            if ina:
                out.append(a)
            if ina != inb:
                t = (bound - a[axis]) / (b[axis] - a[axis])
                out.append(a + t * (b - a))
        return np.asarray(out, np.float64) if out else np.zeros((0, 2))

    pts = np.asarray(poly, np.float64)
    pts = clip_half(pts, 0, lo[0], keep_leq=False)
    pts = clip_half(pts, 0, hi[0], keep_leq=True)
    pts = clip_half(pts, 1, lo[1], keep_leq=False)
    pts = clip_half(pts, 1, hi[1], keep_leq=True)
    return pts


def _poly_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(
        float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    )


def _convex_intersection_area(pa: np.ndarray, pb: np.ndarray) -> float:
    """Area of the intersection of two convex polygons (clip a by b's
    half-planes)."""
    pts = np.asarray(pa, np.float64)
    nb = len(pb)
    # pb counter-clockwise orientation
    if _signed_area(pb) < 0:
        pb = pb[::-1]
    for i in range(nb):
        a = pb[i]
        b = pb[(i + 1) % nb]
        e = b - a
        if len(pts) == 0:
            return 0.0
        d = (pts[:, 0] - a[0]) * e[1] - (pts[:, 1] - a[1]) * e[0]
        inside = d <= 1e-15
        out = []
        n = len(pts)
        for j in range(n):
            pj, pk = pts[j], pts[(j + 1) % n]
            inj, ink = inside[j], inside[(j + 1) % n]
            if inj:
                out.append(pj)
            if inj != ink:
                dj, dk = d[j], d[(j + 1) % n]
                t = dj / (dj - dk)
                out.append(pj + t * (pk - pj))
        pts = np.asarray(out, np.float64) if out else np.zeros((0, 2))
        if len(pts) == 0:
            return 0.0
        d = (pts[:, 0] - a[0]) * e[1] - (pts[:, 1] - a[1]) * e[0]
        inside = d <= 1e-15
    return _poly_area(pts)


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _maximal_rectangles(cov: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """All maximal all-True rectangles (i0, j0, i1, j1) of a boolean grid
    (half-open index ranges), via the histogram-stack sweep per bottom row."""
    h, w = cov.shape
    heights = np.zeros(w, np.int64)
    rects = set()
    for i in range(h):
        heights = np.where(cov[i], heights + 1, 0)
        # maximal rectangles with bottom edge on row i: pop STRICTLY taller
        # entries (equal heights stay — popping on equality would emit one
        # nested rect per column of an equal-height run)
        stack: List[Tuple[int, int]] = []  # (start_col, height)
        for j in range(w + 1):
            cur = int(heights[j]) if j < w else 0
            start = j
            while stack and stack[-1][1] > cur:
                s, hh = stack.pop()
                # left/right-maximal by stack discipline (strictly shorter
                # columns on both sides); height-maximal upward since hh
                # counts ALL consecutive covered rows; downward iff row i+1
                # doesn't extend the full width
                if i + 1 >= h or not cov[i + 1, s:j].all():
                    rects.add((i + 1 - hh, s, i + 1, j))
                start = s
            if cur > 0 and (not stack or stack[-1][1] < cur):
                stack.append((start, cur))
    return sorted(rects)


@profiling.timed("pack", "occluders")
def extract_occluders(
    mesh,
    min_side_frac: float = 0.02,
    min_area_frac: float = 0.0012,
    max_occluders: int = 96,
    max_grid: int = 768,
    margin_frac: float = 5e-5,
    sep_margin_frac: float = 1.5e-3,
    coord_tol_frac: float = 1e-6,
    device="cuda",
) -> Optional[OccluderSet]:
    """Extract proven axis-aligned rectangular occluders from a mesh.

    Fractions are relative to the scene diameter (min_area_frac to its
    square).  Returns None when no rectangle passes the proof + size
    filters (the trace then runs exactly as before).
    """
    tri = np.asarray(mesh.triangle_corners(), np.float64)  # [F, 3, 3]
    if len(tri) == 0:
        return None
    lo = tri.reshape(-1, 3).min(axis=0)
    hi = tri.reshape(-1, 3).max(axis=0)
    diam = float(np.linalg.norm(hi - lo))
    if diam <= 0:
        return None
    tol = coord_tol_frac * diam
    min_side = min_side_frac * diam
    min_area = min_area_frac * diam * diam
    margin = margin_frac * diam

    found: List[Tuple[float, int, float, float, float, float, float]] = []
    for k in range(3):
        coord = tri[:, :, k]
        flat = np.abs(coord - coord[:, :1]).max(axis=1) <= tol
        if not flat.any():
            continue
        a_ax, b_ax = (k + 1) % 3, (k + 2) % 3
        p_all = coord[flat, 0]
        tri2 = tri[flat][:, :, (a_ax, b_ax)]  # [Fk, 3, 2]
        # group by quantized plane offset
        q = np.round(p_all / max(tol, 1e-12)).astype(np.int64)
        for qv in np.unique(q):
            sel = q == qv
            p = float(p_all[sel].mean())
            polys = tri2[sel]
            rects = _proven_rectangles(
                polys, tol=tol, max_grid=max_grid,
                min_side=min_side, min_area=min_area,
            )
            for (area, a0, b0, a1, b1) in rects:
                found.append((area, k, p, a0, b0, a1, b1))

    if not found:
        return None
    found.sort(reverse=True)
    found = found[:max_occluders]
    axis = np.asarray([f[1] for f in found], np.int32)
    p = np.asarray([f[2] for f in found], np.float32)
    rect_lo = np.asarray([[f[3] + margin, f[4] + margin] for f in found],
                         np.float32)
    rect_hi = np.asarray([[f[5] - margin, f[6] - margin] for f in found],
                         np.float32)
    keep = (rect_hi > rect_lo).all(axis=1)
    if not keep.any():
        return None
    dev = resolve_device(device)
    return OccluderSet(
        axis=tuple(int(a) for a in axis[keep]),
        p=torch.from_numpy(p[keep]).to(dev),
        rect_lo=torch.from_numpy(rect_lo[keep]).to(dev),
        rect_hi=torch.from_numpy(rect_hi[keep]).to(dev),
        sep_margin=float(np.float32(sep_margin_frac * diam)),
    )


def _proven_rectangles(
    polys: np.ndarray, tol: float, max_grid: int,
    min_side: float, min_area: float,
) -> List[Tuple[float, float, float, float, float]]:
    """Proven fully-covered rectangles of one plane's triangle set.

    polys: [F, 3, 2] float64 projected triangles.  Returns a list of
    (area, a0, b0, a1, b1)."""
    # dedupe identical triangles (double-sided walls duplicate geometry):
    # unordered vertex multiset, quantized
    qv = np.round(polys / max(tol, 1e-12)).astype(np.int64)  # [F, 3, 2]
    key = np.sort(
        qv[:, :, 0] * np.int64(2**31) + qv[:, :, 1], axis=1
    )
    _, first = np.unique(key, axis=0, return_index=True)
    polys = polys[np.sort(first)]
    qv = qv[np.sort(first)]

    # arrangement grid from unique quantized coords
    xs_q = np.unique(qv[:, :, 0])
    ys_q = np.unique(qv[:, :, 1])
    if len(xs_q) < 2 or len(ys_q) < 2:
        return []
    if len(xs_q) > max_grid or len(ys_q) > max_grid:
        return []  # over-dense arrangement: skip (conservative)
    # representative world coords per quantized value
    xmap = {int(v): 0.0 for v in xs_q}
    ymap = {int(v): 0.0 for v in ys_q}
    for f in range(len(polys)):
        for c in range(3):
            xmap[int(qv[f, c, 0])] = float(polys[f, c, 0])
            ymap[int(qv[f, c, 1])] = float(polys[f, c, 1])
    xs = np.asarray([xmap[int(v)] for v in xs_q])
    ys = np.asarray([ymap[int(v)] for v in ys_q])

    nx, ny = len(xs) - 1, len(ys) - 1
    cov_area = np.zeros((ny, nx), np.float64)
    slow_cells: dict = {}
    fast_sigs: dict = {}

    # fast path: half-cell lattice triangles (3 vertices on 3 distinct
    # corners of a single grid cell).  A cell is covered by the fast path
    # iff it holds BOTH halves of one diagonal — signature pairs whose
    # union is all 4 corners and whose intersection is a true diagonal
    # ({(0,0),(1,1)} or {(0,1),(1,0)}); same-side or opposite-diagonal
    # pairs overlap and prove nothing.
    xi = np.searchsorted(xs_q, qv[:, :, 0])
    yi = np.searchsorted(ys_q, qv[:, :, 1])
    xi_lo, xi_hi = xi.min(axis=1), xi.max(axis=1)
    yi_lo, yi_hi = yi.min(axis=1), yi.max(axis=1)
    half_cell = (xi_hi - xi_lo == 1) & (yi_hi - yi_lo == 1)
    # corner ids within the cell: (xoff)*2 + (yoff) ∈ {0, 1, 2, 3}
    corner_id = (xi - xi_lo[:, None]) * 2 + (yi - yi_lo[:, None])
    distinct = np.asarray(
        [len(set(map(int, row))) == 3 for row in corner_id]
    )
    half_cell &= distinct
    for f in np.nonzero(half_cell)[0]:
        i, j = int(yi_lo[f]), int(xi_lo[f])
        fast_sigs.setdefault((i, j), set()).add(
            frozenset(map(int, corner_id[f]))
        )

    _DIAGS = (frozenset((0, 3)), frozenset((1, 2)))

    def fast_covered(sigs) -> bool:
        sigs = list(sigs)
        for a in range(len(sigs)):
            for b in range(a + 1, len(sigs)):
                inter = sigs[a] & sigs[b]
                if len(sigs[a] | sigs[b]) == 4 and inter in _DIAGS:
                    return True
        return False

    # slow path: everything else, clipped per touched cell with pairwise
    # overlap rejection (area-sum is a union proof only without overlap)
    for f in np.nonzero(~half_cell)[0]:
        poly = polys[f]
        j0 = max(int(np.searchsorted(xs, poly[:, 0].min() + tol) - 1), 0)
        j1 = min(int(np.searchsorted(xs, poly[:, 0].max() - tol)), nx)
        i0 = max(int(np.searchsorted(ys, poly[:, 1].min() + tol) - 1), 0)
        i1 = min(int(np.searchsorted(ys, poly[:, 1].max() - tol)), ny)
        if (j1 - j0) * (i1 - i0) > 64:
            continue  # cap the work; uncounted area is conservative
        for i in range(i0, i1):
            for j in range(j0, j1):
                clip = _clip_poly_to_box(
                    poly, (xs[j], ys[i]), (xs[j + 1], ys[i + 1])
                )
                a = _poly_area(clip)
                if a <= 0:
                    continue
                slow_cells.setdefault((i, j), []).append(clip)
                cov_area[i, j] += a

    # overlap rejection for slow cells: area-sum proves the union only when
    # the clipped polygons are pairwise disjoint
    for (i, j), clips in slow_cells.items():
        ok = True
        for aidx in range(len(clips)):
            for bidx in range(aidx + 1, len(clips)):
                if _convex_intersection_area(clips[aidx], clips[bidx]) > tol * tol:
                    ok = False
                    break
            if not ok:
                break
        if not ok:
            cov_area[i, j] = 0.0

    cell_w = np.diff(xs)[None, :]
    cell_h = np.diff(ys)[:, None]
    cell_area = cell_w * cell_h
    # slow-path covered: union area (== sum, overlap-free) fills the cell.
    # The 1e-6 relative slack absorbs f64 clip arithmetic on f32-snapped
    # coords; over-covered cells would mean an undetected overlap — reject.
    covered = (cov_area >= cell_area * (1 - 1e-6)) & (
        cov_area <= cell_area * (1 + 1e-6)
    )
    # the fast proof (a complementary diagonal half-pair) is sufficient on
    # its own — coverage is monotone, extra triangles never invalidate a
    # covering subset — so it ORs with the slow-path proof
    for (i, j), sigs in fast_sigs.items():
        if fast_covered(sigs):
            covered[i, j] = True

    out = []
    for (i0, j0, i1, j1) in _maximal_rectangles(covered):
        a0, a1 = xs[j0], xs[j1]
        b0, b1 = ys[i0], ys[i1]
        if (a1 - a0) < min_side or (b1 - b0) < min_side:
            continue
        area = (a1 - a0) * (b1 - b0)
        if area < min_area:
            continue
        out.append((area, a0, b0, a1, b1))
    return out


# ---------------------------------------------------------------------------
# device-side blocking test (used by ops.pallas_culled.cull_blocks)
# ---------------------------------------------------------------------------

def occluder_plane_bounds(
    occ: OccluderSet,
    bo_lo, bo_hi,      # 3-tuples of [G] group origin-box bounds
    d_lo, d_hi,        # 3-tuples of [G] group direction-cone bounds
):
    """Per-group effective blocking planes (p_eff_lo, p_eff_hi), each [3, G].

    For axis k: every cluster with lo_k strictly greater than p_eff_hi[k]
    (resp. hi_k strictly less than p_eff_lo[k]) is provably unreachable by
    every ray of the group.  The crossing-point interval of rays
    (o ∈ origin box, d ∈ cone) at plane x_k = p is o_ab + gap·(d_ab/d_k),
    composed conservatively from the three intervals; blocking requires the
    origin box separated from the plane by sep_margin and the cone strictly
    toward it."""
    g = bo_lo[0].shape[0]
    dev = bo_lo[0].device
    BO_LO = torch.stack(bo_lo)   # [3, G]
    BO_HI = torch.stack(bo_hi)
    D_LO = torch.stack(d_lo)
    D_HI = torch.stack(d_hi)

    ax = occ.axis_index   # [K]
    a_ax = (ax + 1) % 3
    b_ax = (ax + 2) % 3
    p = occ.p[:, None]         # [K, 1]
    m = occ.sep_margin

    o_lo_k, o_hi_k = BO_LO[ax], BO_HI[ax]   # [K, G]
    dk_lo, dk_hi = D_LO[ax], D_HI[ax]

    def cross_within(gap_lo, gap_hi, dkl, dkh, axes):
        """Crossing interval containment for one rect axis set."""
        within = torch.ones(gap_lo.shape, dtype=torch.bool, device=dev)
        for col, aidx in enumerate(axes):
            da_lo, da_hi = D_LO[aidx], D_HI[aidx]
            # ratio interval r = d_a / d_k over the 4 corner combos
            r00 = da_lo / dkl
            r01 = da_lo / dkh
            r10 = da_hi / dkl
            r11 = da_hi / dkh
            r_lo = torch.minimum(torch.minimum(r00, r01), torch.minimum(r10, r11))
            r_hi = torch.maximum(torch.maximum(r00, r01), torch.maximum(r10, r11))
            # product interval gap·r (gap > 0)
            c00 = gap_lo * r_lo
            c01 = gap_lo * r_hi
            c10 = gap_hi * r_lo
            c11 = gap_hi * r_hi
            prod_lo = torch.minimum(torch.minimum(c00, c01), torch.minimum(c10, c11))
            prod_hi = torch.maximum(torch.maximum(c00, c01), torch.maximum(c10, c11))
            cr_lo = BO_LO[aidx] + prod_lo
            cr_hi = BO_HI[aidx] + prod_hi
            within &= (cr_lo >= occ.rect_lo[:, col:col + 1]) & (
                cr_hi <= occ.rect_hi[:, col:col + 1]
            )
        return within

    # group below the plane, cone strictly upward in k
    gap_lo_u = p - o_hi_k
    gap_hi_u = p - o_lo_k
    up_ok = (gap_lo_u >= m) & (dk_lo >= _D_MIN)
    blocked_up = up_ok & cross_within(
        torch.clamp_min(gap_lo_u, m), gap_hi_u,
        torch.clamp_min(dk_lo, _D_MIN), torch.clamp_min(dk_hi, _D_MIN),
        (a_ax, b_ax),
    )
    # group above the plane, cone strictly downward in k (mirror k)
    gap_lo_d = o_lo_k - p
    gap_hi_d = o_hi_k - p
    dn_ok = (gap_lo_d >= m) & (dk_hi <= -_D_MIN)
    blocked_dn = dn_ok & cross_within(
        torch.clamp_min(gap_lo_d, m), gap_hi_d,
        torch.clamp_min(-dk_hi, _D_MIN), torch.clamp_min(-dk_lo, _D_MIN),
        (a_ax, b_ax),
    )

    inf = float("inf")
    pk = p.expand_as(blocked_up)
    p_eff_hi = torch.full((3, g), inf, dtype=torch.float32, device=dev)
    p_eff_lo = torch.full((3, g), -inf, dtype=torch.float32, device=dev)
    for k in range(3):
        on_axis = (ax == k)[:, None]
        p_eff_hi[k] = torch.where(
            on_axis & blocked_up, pk, torch.full_like(pk, inf)
        ).amin(dim=0)
        p_eff_lo[k] = torch.where(
            on_axis & blocked_dn, pk, torch.full_like(pk, -inf)
        ).amax(dim=0)
    return p_eff_lo, p_eff_hi


def occluder_blocked_clusters(
    occ: OccluderSet,
    bo_lo, bo_hi,          # 3-tuples of [G] group origin-box bounds
    d_lo, d_hi,            # 3-tuples of [G] group direction-cone bounds
    cluster_lo, cluster_hi,  # [C, 3] cluster AABBs
):
    """[G, C] mask of clusters provably unreachable by every ray of each
    group — the cull-time PVS test.

    Two conservative shaft arguments are OR-ed per occluder: the cone
    crossing of occluder_plane_bounds, and the direction-free box-union
    shaft (every segment from the origin box O to a cluster box B crosses
    the separating plane at a convex combination of its endpoints, so if
    that crossing interval fits inside the proven rectangle, every such
    segment hits the occluder strictly first)."""
    g = bo_lo[0].shape[0]
    c = cluster_lo.shape[0]
    dev = cluster_lo.device

    # cone path → per-axis effective planes → cluster compare
    p_eff_lo, p_eff_hi = occluder_plane_bounds(occ, bo_lo, bo_hi, d_lo, d_hi)
    m = occ.sep_margin
    blocked = torch.zeros((g, c), dtype=torch.bool, device=dev)
    for k in range(3):
        blocked |= cluster_lo[None, :, k] > p_eff_hi[k][:, None] + m
        blocked |= cluster_hi[None, :, k] < p_eff_lo[k][:, None] - m

    # box-shaft path, per occluder: the crossing point of a segment o→h at
    # the plane is (1−s)·o + s·h with s = (p−o_k)/(h_k−o_k); with strict
    # separation s ∈ [s_min, s_max] from the box bounds, and the crossing
    # interval per rect axis is the hull of the two endpoint evaluations
    BO_LO = torch.stack(bo_lo)
    BO_HI = torch.stack(bo_hi)
    for i in range(occ.num_occluders):
        k = int(occ.axis[i])
        a, b = (k + 1) % 3, (k + 2) % 3
        p = occ.p[i]

        for sign in (+1, -1):
            # sign=+1: group below the plane, cluster above; −1 mirrored.
            if sign > 0:
                o_near, o_far = BO_HI[k][:, None], BO_LO[k][:, None]
                c_near = cluster_lo[None, :, k]
                c_far = cluster_hi[None, :, k]
                side = (o_near <= p - m) & (c_near > p + m)
                gap_lo = p - o_near
                gap_hi = p - o_far
                den_max = c_near - o_far     # pairs with gap_hi
                den_min = c_far - o_near     # pairs with gap_lo
            else:
                o_near, o_far = BO_LO[k][:, None], BO_HI[k][:, None]
                c_near = cluster_hi[None, :, k]
                c_far = cluster_lo[None, :, k]
                side = (o_near >= p + m) & (c_near < p - m)
                gap_lo = o_near - p
                gap_hi = o_far - p
                den_max = o_far - c_near
                den_min = o_near - c_far
            s_max = gap_hi / torch.clamp_min(den_max, 1e-12)
            s_min = gap_lo / torch.clamp_min(den_min, 1e-12)
            fit = torch.ones((g, c), dtype=torch.bool, device=dev)
            for col, aidx in ((0, a), (1, b)):
                o_lo_a = BO_LO[aidx][:, None]
                o_hi_a = BO_HI[aidx][:, None]
                c_lo_a = cluster_lo[None, :, aidx]
                c_hi_a = cluster_hi[None, :, aidx]
                lo1 = o_lo_a + s_min * (c_lo_a - o_lo_a)
                lo2 = o_lo_a + s_max * (c_lo_a - o_lo_a)
                hi1 = o_hi_a + s_min * (c_hi_a - o_hi_a)
                hi2 = o_hi_a + s_max * (c_hi_a - o_hi_a)
                fit &= (torch.minimum(lo1, lo2) >= occ.rect_lo[i, col]) & (
                    torch.maximum(hi1, hi2) <= occ.rect_hi[i, col]
                )
            blocked |= side & fit
    return blocked
