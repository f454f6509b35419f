"""Skip-link ("threaded") BVH builder for stackless TPU traversal.

This is the host-side half of the ray-casting engine that replaces the
reference's CPU Embree scene (`o3d.t.geometry.RaycastingScene`, reference
models/mat_nvdiffrast.py:98-101).  The device half is
texir_code_tpu_torch.ops.raycast.

Why skip links: TPU traversal is a lockstep SIMD loop over a ray batch.  A
per-ray stack costs VMEM and divergent pushes/pops; instead nodes are laid
out in depth-first order and each node stores a *miss link* — the DFS index
of the next node to visit when its AABB is missed (or after a leaf is
processed).  Traversal state per ray collapses to a single node index:

    hit inner node  -> next = node + 1        (its first child, by DFS order)
    miss / leaf done-> next = miss_link[node] (-1 terminates)

Triangles are reordered so every leaf's triangles are contiguous and padded
to the leaf width, making the leaf-intersection gather fixed-shape.

Build is binned-SAH (fallback median) over triangle centroids, iterative, in
numpy.  A C++ builder with the same output contract can be swapped in for
very large scenes; the arrays below are the interface.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from texir_code_tpu_torch import profiling


SUPERNODE_WIDTH = 48


@dataclasses.dataclass
class FlatBVH:
    """Flattened skip-link BVH + reordered triangle soup (all numpy, fp32/i32).

    Node arrays (DFS order, length N):
        aabb_min, aabb_max: [N, 3]
        miss: [N] DFS index to jump to on AABB miss / after a leaf; -1 = done.
        leaf_start: [N] first padded-triangle slot (leaves) or -1 (inner).
        leaf_count: [N] number of valid triangles in the leaf (0 for inner).

    Triangle arrays (padded leaf-major order, length M = n_leaves * leaf_width):
        tri_p0, tri_e1, tri_e2: [M, 3] Möller–Trumbore precomputation
            (corner 0, edge1 = p1-p0, edge2 = p2-p0).  Padded slots are
            degenerate (zeros) and additionally masked by leaf_count.
        tri_prim: [M] original face index (the Open3D `primitive_ids`
            contract the reference relies on, models/mat_nvdiffrast.py:301).

    `leaf_width` is the static per-leaf triangle budget of the traversal
    kernel's unrolled intersection loop.
    """

    aabb_min: np.ndarray
    aabb_max: np.ndarray
    miss: np.ndarray
    leaf_start: np.ndarray
    leaf_count: np.ndarray
    tri_p0: np.ndarray
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    tri_prim: np.ndarray
    leaf_width: int

    @property
    def num_nodes(self) -> int:
        return int(self.aabb_min.shape[0])

    def pack_supernodes(self) -> np.ndarray:
        """Pack each node (and, for leaves, its triangles) into one flat row.

        TPU traversal is gather-throughput-bound (~0.2 G rows/s regardless of
        row width — measured), so the hot loop must issue exactly ONE gather
        per visited node.  Row layout ([N, 8+10·lw] float32, ints bitcast;
        lw = leaf_width, default 4 → width 48):

            [0:3]       aabb_min          [3:6] aabb_max
            [6]         miss link (i32)   [7]   leaf_count (i32; 0 = inner)
            [8 : 8+lw]  per-triangle prim id (i32)
            [8+lw+9j : 8+lw+9j+9] triangle j: p0(3), e1(3), e2(3)
        """
        lw = self.leaf_width
        width = 8 + 10 * lw
        n = self.num_nodes
        rows = np.zeros((n, width), np.float32)
        rows[:, 0:3] = self.aabb_min
        rows[:, 3:6] = self.aabb_max
        rows[:, 6] = self.miss.view(np.float32)
        rows[:, 7] = self.leaf_count.view(np.float32)
        is_leaf = self.leaf_count > 0
        leaf_rows = np.nonzero(is_leaf)[0]
        starts = self.leaf_start[leaf_rows]
        tbase = 8 + lw
        for j in range(lw):
            sl = starts + j
            rows[leaf_rows, 8 + j] = self.tri_prim[sl].view(np.float32)
            rows[leaf_rows, tbase + 9 * j : tbase + 9 * j + 3] = self.tri_p0[sl]
            rows[leaf_rows, tbase + 9 * j + 3 : tbase + 9 * j + 6] = self.tri_e1[sl]
            rows[leaf_rows, tbase + 9 * j + 6 : tbase + 9 * j + 9] = self.tri_e2[sl]
        return rows


_SAH_BINS = 16


def _sah_split(
    cmin: np.ndarray, cmax: np.ndarray, cent: np.ndarray, idx: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Binned SAH split of triangle indices `idx`; None if no good split."""
    lo = cent[idx].min(axis=0)
    hi = cent[idx].max(axis=0)
    extent = hi - lo
    axis = int(np.argmax(extent))
    if extent[axis] <= 1e-12:
        return None
    # bin triangles by centroid
    scale = _SAH_BINS * (1.0 - 1e-6) / extent[axis]
    bins = ((cent[idx, axis] - lo[axis]) * scale).astype(np.int32)
    bins = np.clip(bins, 0, _SAH_BINS - 1)

    # per-bin counts and bounds
    counts = np.bincount(bins, minlength=_SAH_BINS)
    bmin = np.full((_SAH_BINS, 3), np.inf, np.float32)
    bmax = np.full((_SAH_BINS, 3), -np.inf, np.float32)
    for b in range(_SAH_BINS):
        sel = bins == b
        if counts[b]:
            bmin[b] = cmin[idx[sel]].min(axis=0)
            bmax[b] = cmax[idx[sel]].max(axis=0)

    def area(mn, mx):
        d = np.maximum(mx - mn, 0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    # prefix/suffix sweeps
    lmin = np.minimum.accumulate(bmin, axis=0)
    lmax = np.maximum.accumulate(bmax, axis=0)
    rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
    lcount = np.cumsum(counts)
    rcount = np.cumsum(counts[::-1])[::-1]

    costs = np.full(_SAH_BINS - 1, np.inf)
    for s in range(_SAH_BINS - 1):
        if lcount[s] == 0 or rcount[s + 1] == 0:
            continue
        costs[s] = area(lmin[s], lmax[s]) * lcount[s] + area(
            rmin[s + 1], rmax[s + 1]
        ) * rcount[s + 1]
    s = int(np.argmin(costs))
    if not np.isfinite(costs[s]):
        return None
    left = idx[bins <= s]
    right = idx[bins > s]
    if len(left) == 0 or len(right) == 0:
        return None
    return left, right


@profiling.timed("pack", "bvh")
def build_bvh(
    vertices: np.ndarray,
    faces: np.ndarray,
    leaf_width: int = 4,
    use_sah: bool = True,
    use_native: bool = True,
) -> FlatBVH:
    """Build a skip-link BVH over a triangle mesh.

    Dispatches to the C++ builder (texir_code_tpu_torch.native) when available —
    same output contract, ~20-50× faster on scan-scale meshes; this numpy
    implementation is the fallback and the test oracle.

    Args:
        vertices: [V, 3] float.
        faces: [F, 3] int.
        leaf_width: max triangles per leaf (static unroll width on device).
        use_sah: binned-SAH splits (median fallback when SAH degenerates).
        use_native: allow the C++ fast path.
    """
    if use_native and use_sah:
        from texir_code_tpu_torch import native

        fb = native.build_bvh_native(vertices, faces, leaf_width)
        if fb is not None:
            return fb
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    tri = vertices[faces]  # [F, 3, 3]
    cmin = tri.min(axis=1)
    cmax = tri.max(axis=1)
    cent = (cmin + cmax) * 0.5
    nf = faces.shape[0]

    # --- recursive structure, built iteratively ---------------------------
    # each record: (tri index array, parent's child slot fixup handled by DFS)
    nodes_min, nodes_max, nodes_tris = [], [], []  # per-node AABB & leaf tris
    children: list = []  # (left_node, right_node) or None for leaf

    def make_node(idx: np.ndarray) -> int:
        node_id = len(nodes_min)
        nodes_min.append(cmin[idx].min(axis=0))
        nodes_max.append(cmax[idx].max(axis=0))
        nodes_tris.append(None)
        children.append(None)
        return node_id

    root = make_node(np.arange(nf))
    stack = [(root, np.arange(nf))]
    while stack:
        node_id, idx = stack.pop()
        if len(idx) <= leaf_width:
            nodes_tris[node_id] = idx
            continue
        split = _sah_split(cmin, cmax, cent, idx) if use_sah else None
        if split is None:
            # median split on the longest centroid axis
            lo = cent[idx].min(axis=0)
            hi = cent[idx].max(axis=0)
            axis = int(np.argmax(hi - lo))
            order = np.argsort(cent[idx, axis], kind="stable")
            half = len(idx) // 2
            split = (idx[order[:half]], idx[order[half:]])
        left_idx, right_idx = split
        left = make_node(left_idx)
        right = make_node(right_idx)
        children[node_id] = (left, right)
        # push right first so left is processed first (DFS order comes later)
        stack.append((right, right_idx))
        stack.append((left, left_idx))

    # --- DFS flattening with miss links ----------------------------------
    n = len(nodes_min)
    dfs_order = np.empty(n, np.int32)
    miss = np.full(n, -1, np.int32)
    leaf_start = np.full(n, -1, np.int32)
    leaf_count = np.zeros(n, np.int32)
    new_id = np.empty(n, np.int32)

    # iterative DFS assigning new ids; miss link = next sibling-or-ancestor's
    # right subtree in DFS order
    counter = 0
    # stack holds (old_id, miss_old_id) where miss is the node to jump to
    dfs_stack = [(root, -1)]
    order_old = []
    miss_old = {}
    while dfs_stack:
        old, miss_node = dfs_stack.pop()
        new_id[old] = counter
        order_old.append(old)
        miss_old[old] = miss_node
        counter += 1
        ch = children[old]
        if ch is not None:
            left, right = ch
            dfs_stack.append((right, miss_node))
            dfs_stack.append((left, right))

    # triangle reordering: walk leaves in DFS order, pack padded slots
    leaf_tri_blocks = []
    aabb_min = np.empty((n, 3), np.float32)
    aabb_max = np.empty((n, 3), np.float32)
    slot = 0
    for old in order_old:
        nid = new_id[old]
        aabb_min[nid] = nodes_min[old]
        aabb_max[nid] = nodes_max[old]
        m = miss_old[old]
        miss[nid] = new_id[m] if m != -1 else -1
        tris = nodes_tris[old]
        if tris is not None:
            leaf_start[nid] = slot
            leaf_count[nid] = len(tris)
            pad = np.full(leaf_width, -1, np.int64)
            pad[: len(tris)] = tris
            leaf_tri_blocks.append(pad)
            slot += leaf_width

    if leaf_tri_blocks:
        packed = np.concatenate(leaf_tri_blocks)
    else:
        packed = np.zeros(0, np.int64)
    valid = packed >= 0
    safe = np.where(valid, packed, 0)
    p0 = tri[safe, 0].astype(np.float32)
    e1 = (tri[safe, 1] - tri[safe, 0]).astype(np.float32)
    e2 = (tri[safe, 2] - tri[safe, 0]).astype(np.float32)
    # degenerate padded slots so they can never report a hit
    p0[~valid] = 0
    e1[~valid] = 0
    e2[~valid] = 0
    tri_prim = np.where(valid, packed, -1).astype(np.int32)

    return FlatBVH(
        aabb_min=aabb_min,
        aabb_max=aabb_max,
        miss=miss,
        leaf_start=leaf_start,
        leaf_count=leaf_count,
        tri_p0=p0,
        tri_e1=e1,
        tri_e2=e2,
        tri_prim=tri_prim,
        leaf_width=leaf_width,
    )
