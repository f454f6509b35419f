"""Synthetic scenes for tests, the demo and the chip smoke run.

Self-contained stand-ins for the reference's proprietary scan data, with
known ground-truth materials and the emitters baked into the HDR atlas
(the TBL emitter):
  * `make_scene` — one uv-atlased box room with a ceiling lamp (the demo
    and the small tests);
  * `make_apartment_scene` — a box room split by a divider wall with a
    doorway, plus clutter boxes, ceiling lamps and wall sconces: the bench
    scene (`make_apartment_scene(atlas_res=256, subdiv=24)`).

A copy of the JAX package's `data/synthetic.py` functions for these scenes
and the helpers they need; outputs are identical for equal arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from texir_code_tpu_torch.geometry.mesh import Mesh


def _cell_uv(face_idx: int, margin: float = 0.02, grid: int = 3) -> np.ndarray:
    """[4, 2] uv corners of face chart `face_idx` in the grid×2 atlas."""
    cx, cy = face_idx % grid, face_idx // grid
    u0 = cx / grid + margin
    u1 = (cx + 1) / grid - margin
    v0 = cy / 2.0 + margin
    v1 = (cy + 1) / 2.0 - margin
    return np.array([[u0, v0], [u1, v0], [u1, v1], [u0, v1]], np.float32)


def make_room_mesh(
    size: Tuple[float, float, float] = (4.0, 3.0, 5.0),
    subdiv: int = 1,
) -> Mesh:
    """Closed box room, inward-facing normals, one chart per wall.

    Args:
        subdiv: tessellate each wall into subdiv×subdiv quads
            (12·subdiv² triangles total) — scan meshes are dense, so
            benchmarks use subdiv ≫ 1 to give the BVH realistic depth.
    """
    sx, sy, sz = size
    lo = np.array([0.0, 0.0, 0.0], np.float32)
    hi = np.array([sx, sy, sz], np.float32)

    def wall(corners):
        return np.asarray(corners, np.float32)

    # each wall: 4 corners counter-clockwise when seen from inside
    walls = [
        wall([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
              [hi[0], lo[1], hi[2]], [lo[0], lo[1], hi[2]]]),   # floor (+y normal)
        wall([[lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]],
              [hi[0], hi[1], hi[2]], [hi[0], hi[1], lo[2]]]),   # ceiling (-y)
        wall([[lo[0], lo[1], lo[2]], [lo[0], hi[1], lo[2]],
              [hi[0], hi[1], lo[2]], [hi[0], lo[1], lo[2]]]),   # back z=0 (+z)
        wall([[lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
              [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]]),   # front z=sz (-z)
        wall([[lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]],
              [lo[0], hi[1], hi[2]], [lo[0], hi[1], lo[2]]]),   # left x=0 (+x)
        wall([[hi[0], lo[1], lo[2]], [hi[0], hi[1], lo[2]],
              [hi[0], hi[1], hi[2]], [hi[0], lo[1], hi[2]]]),   # right (-x)
    ]

    vertices, faces, uvs, uv_faces = [], [], [], []
    for k, corners in enumerate(walls):
        uv4 = _cell_uv(k)
        # bilinear lattice over the wall and its uv chart
        n = subdiv
        for iy in range(n + 1):
            for ix in range(n + 1):
                s, t = ix / n, iy / n
                p = _quad_point(corners, s, t)
                q = (
                    (1 - s) * (1 - t) * uv4[0]
                    + s * (1 - t) * uv4[1]
                    + s * t * uv4[2]
                    + (1 - s) * t * uv4[3]
                )
                vertices.append(p.astype(np.float32))
                uvs.append(q.astype(np.float32))
        base = len(vertices) - (n + 1) * (n + 1)
        ubase = len(uvs) - (n + 1) * (n + 1)
        for iy in range(n):
            for ix in range(n):
                a = base + iy * (n + 1) + ix
                b = a + 1
                c = a + (n + 1) + 1
                d = a + (n + 1)
                ua, ub, uc, ud = (
                    ubase + iy * (n + 1) + ix,
                    ubase + iy * (n + 1) + ix + 1,
                    ubase + (iy + 1) * (n + 1) + ix + 1,
                    ubase + (iy + 1) * (n + 1) + ix,
                )
                faces.append([a, b, c])
                faces.append([a, c, d])
                uv_faces.append([ua, ub, uc])
                uv_faces.append([ua, uc, ud])

    mesh = Mesh(
        vertices=np.asarray(vertices, np.float32),
        faces=np.asarray(faces, np.int32),
        uvs=np.asarray(uvs, np.float32),
        uv_faces=np.asarray(uv_faces, np.int32),
    )
    # scan meshes of rooms are inward-facing; shading offsets p+ε·n assume it
    mesh.orient_faces_toward((lo + hi) / 2.0)
    mesh.compute_vertex_normals()
    return mesh


def _chart_slice(face_idx: int, res: int, grid: int = 3) -> Tuple[slice, slice]:
    """Texture rows/cols of face chart `face_idx` (v-up row order: row index
    grows with v)."""
    cx, cy = face_idx % grid, face_idx // grid
    rows = slice(cy * res // 2, (cy + 1) * res // 2)
    cols = slice(cx * res // grid, (cx + 1) * res // grid)
    return rows, cols


@dataclasses.dataclass
class SyntheticScene:
    mesh: Mesh
    hdr_texture: np.ndarray      # [R, R, 3] emitter atlas (TBL)
    gt_albedo: np.ndarray        # [R, R, 3] ground-truth albedo
    gt_roughness: np.ndarray     # [R, R, 1]
    seg_texture: np.ndarray      # [R, R] int32 per-texel seg class (=wall id)
    lamp_radiance: float
    size: Tuple[float, float, float]
    # room segmentation in the reference's occupancy-grid format
    # (scale, w, h, x_min, z_min, room_img [H, W] uint8), matching
    # utils/general.py:115-125 parse_roomseg; None for single-room scenes
    roomseg: Optional[tuple] = None

    def camera_positions(self, n: int = 4) -> np.ndarray:
        """n interior camera positions on a ring."""
        sx, sy, sz = self.size
        t = np.linspace(0, 2 * np.pi, n, endpoint=False)
        return np.stack(
            [
                sx / 2 + 0.25 * sx * np.cos(t),
                np.full_like(t, sy * 0.5),
                sz / 2 + 0.25 * sz * np.sin(t),
            ],
            axis=-1,
        ).astype(np.float32)


def make_scene(
    atlas_res: int = 96,
    lamp_radiance: float = 20.0,
    size: Tuple[float, float, float] = (4.0, 3.0, 5.0),
    seed: int = 666,
    subdiv: int = 1,
) -> SyntheticScene:
    """Build the synthetic room.

    The HDR atlas approximates an already-lit scan: walls carry moderate
    radiosity values per wall color; the ceiling chart contains a small very
    bright lamp patch (the only texels above the VHL threshold).
    """
    rng = np.random.default_rng(seed)
    mesh = make_room_mesh(size, subdiv=subdiv)

    wall_colors = np.array(
        [
            [0.60, 0.55, 0.50],  # floor
            [0.85, 0.85, 0.85],  # ceiling
            [0.70, 0.30, 0.30],  # back (red-ish)
            [0.30, 0.70, 0.35],  # front (green-ish)
            [0.75, 0.75, 0.45],  # left
            [0.45, 0.55, 0.80],  # right
        ],
        np.float32,
    )
    wall_rough = np.array([0.5, 0.7, 0.35, 0.6, 0.25, 0.45], np.float32)

    r = atlas_res
    hdr = np.zeros((r, r, 3), np.float32)
    gt_albedo = np.zeros((r, r, 3), np.float32)
    gt_rough = np.full((r, r, 1), 0.5, np.float32)
    seg = np.zeros((r, r), np.int32)
    for k in range(6):
        rows, cols = _chart_slice(k, r)
        # mild spatial variation so texture gradients are informative
        noise = 1.0 + 0.1 * rng.standard_normal((rows.stop - rows.start,
                                                 cols.stop - cols.start, 1))
        hdr[rows, cols] = wall_colors[k] * 0.3 * noise
        gt_albedo[rows, cols] = wall_colors[k]
        gt_rough[rows, cols] = wall_rough[k]
        seg[rows, cols] = k

    # lamp: central patch of the ceiling chart (face 1)
    rows, cols = _chart_slice(1, r)
    h0 = (rows.start + rows.stop) // 2
    w0 = (cols.start + cols.stop) // 2
    lamp = (slice(h0 - r // 24, h0 + r // 24), slice(w0 - r // 24, w0 + r // 24))
    hdr[lamp[0], lamp[1]] = lamp_radiance

    return SyntheticScene(
        mesh=mesh,
        hdr_texture=hdr,
        gt_albedo=gt_albedo,
        gt_roughness=gt_rough,
        seg_texture=seg,
        lamp_radiance=lamp_radiance,
        size=size,
    )


def make_roomseg(
    size: Tuple[float, float, float],
    room_of_xz,
    cell: float = 0.05,
    margin: float = 0.2,
) -> tuple:
    """Occupancy-grid room segmentation in the reference's format.

    The reference's roomseg assets are a meta line "scale w h x_min z_min"
    plus a uchar room-id image sampled at world (x, z)
    (utils/general.py:115-125; lookup u=(x-x_min)/scale/w at
    trainer/train_material.py:274-282).  `room_of_xz(X, Z)` maps world
    coordinate grids to integer room ids (≥1; 0 = outside)."""
    sx, _, sz = size
    x_min, z_min = -margin, -margin
    w = int(np.ceil((sx + 2 * margin) / cell))
    h = int(np.ceil((sz + 2 * margin) / cell))
    xs = x_min + (np.arange(w) + 0.5) * cell
    zs = z_min + (np.arange(h) + 0.5) * cell
    X, Z = np.meshgrid(xs, zs)  # [h, w]: row = z, col = x
    img = np.asarray(room_of_xz(X, Z), np.uint8)
    return (cell, float(w), float(h), float(x_min), float(z_min), img)


# ---------------------------------------------------------------------------
# multi-room variant (realistic occlusion for benchmarks and culling tests)
# ---------------------------------------------------------------------------


def _quad_point(corners, s: float, t: float) -> np.ndarray:
    """Bilinear quad point with EXACT axis-aligned fast paths.

    The plain bilinear sum `(1-s)(1-t)c0 + …` leaves ulp-level noise even on
    constant axes (e.g. `s(1-t)·x + st·x ≠ s·x` in float), so lattice panels
    meant to be coplanar split into several ulp-separated planes and shared
    panel edges crack by ulps.  Constant axes and axis-parallel edges are
    therefore emitted exactly (endpoint coordinates at s/t ∈ {0, 1}) — the
    occluder extraction's coverage proofs (geometry/occluders.py) rely on
    exact coplanarity of panels in a wall plane."""
    c = np.asarray(corners, np.float64)
    p = np.empty(3, np.float64)
    for k in range(3):
        v0, v1, v2, v3 = c[0, k], c[1, k], c[2, k], c[3, k]
        if v0 == v1 == v2 == v3:
            p[k] = v0
        elif v0 == v3 and v1 == v2:      # varies with s only
            p[k] = v1 if s == 1.0 else v0 + s * (v1 - v0)
        elif v0 == v1 and v2 == v3:      # varies with t only
            p[k] = v3 if t == 1.0 else v0 + t * (v3 - v0)
        else:
            p[k] = ((1 - s) * (1 - t) * v0 + s * (1 - t) * v1
                    + s * t * v2 + (1 - s) * t * v3)
    return p.astype(np.float32)


def _lattice_quad(vertices, faces, uvs, uv_faces, corners, uv4, subdiv):
    """Append a subdiv×subdiv tessellated quad with bilinear uvs."""
    n = subdiv
    base = len(vertices)
    ubase = len(uvs)
    corners = np.asarray(corners, np.float32)
    for iy in range(n + 1):
        for ix in range(n + 1):
            s, t = ix / n, iy / n
            p = _quad_point(corners, s, t)
            q = ((1 - s) * (1 - t) * uv4[0] + s * (1 - t) * uv4[1]
                 + s * t * uv4[2] + (1 - s) * t * uv4[3])
            vertices.append(np.asarray(p, np.float32))
            uvs.append(np.asarray(q, np.float32))
    for iy in range(n):
        for ix in range(n):
            a = base + iy * (n + 1) + ix
            b, c, d = a + 1, a + (n + 1) + 1, a + (n + 1)
            ua = ubase + iy * (n + 1) + ix
            ub, uc, ud = ua + 1, ua + (n + 1) + 1, ua + (n + 1)
            faces.append([a, b, c]); faces.append([a, c, d])
            uv_faces.append([ua, ub, uc]); uv_faces.append([ua, uc, ud])


def make_apartment_scene(
    atlas_res: int = 128,
    lamp_radiance: float = 20.0,
    size: Tuple[float, float, float] = (8.0, 3.0, 5.0),
    seed: int = 666,
    subdiv: int = 1,
    clutter: int = 2,
) -> SyntheticScene:
    """Two-room apartment: the box room split by a divider wall with a
    doorway, plus `clutter` boxes on the floor — the occlusion structure of
    real scan data, where beam culling actually pays.  Atlas: 4×2 grid; cells
    0-5 = outer walls, cell 6 = divider, cell 7 = clutter; a ceiling lamp per
    room."""
    rng = np.random.default_rng(seed)
    sx, sy, sz = size
    lo = np.zeros(3, np.float32)
    hi = np.asarray(size, np.float32)

    walls = [
        [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]], [lo[0], lo[1], hi[2]]],
        [[lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]], [hi[0], hi[1], lo[2]]],
        [[lo[0], lo[1], lo[2]], [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]], [hi[0], lo[1], lo[2]]],
        [[lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]], [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]],
        [[lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]], [lo[0], hi[1], hi[2]], [lo[0], hi[1], lo[2]]],
        [[hi[0], lo[1], lo[2]], [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]], [hi[0], lo[1], hi[2]]],
    ]
    vertices, faces, uvs, uv_faces, chart_of_face = [], [], [], [], []

    def add(corners, chart, sub):
        before = len(faces)
        _lattice_quad(vertices, faces, uvs, uv_faces,
                      np.asarray(corners, np.float32), _cell_uv(chart, grid=4), sub)
        chart_of_face.extend([chart] * (len(faces) - before))

    for k, c in enumerate(walls):
        add(c, k, subdiv)
    n_outer_faces = len(faces)

    # divider at x = 0.55·sx, doorway gap for z in [0.72·sz, 0.95·sz]
    dx = 0.55 * sx
    zdoor = 0.72 * sz
    add([[dx, 0, 0], [dx, sy, 0], [dx, sy, zdoor], [dx, 0, zdoor]], 6,
        max(subdiv, 1))
    # header above the doorway
    add([[dx, 0.75 * sy, zdoor], [dx, sy, zdoor], [dx, sy, 0.95 * sz],
         [dx, 0.75 * sy, 0.95 * sz]], 6, max(subdiv // 2, 1))

    for b in range(clutter):
        cx = (0.15 + 0.6 * rng.random()) * sx
        cz = (0.15 + 0.6 * rng.random()) * sz
        w, h, dpt = 0.4 + 0.4 * rng.random(), 0.5 + 0.5 * rng.random(), 0.4 + 0.4 * rng.random()
        x0, x1 = cx, min(cx + w, sx - 0.05)
        z0, z1 = cz, min(cz + dpt, sz - 0.05)
        quads = [
            [[x0, 0, z0], [x1, 0, z0], [x1, h, z0], [x0, h, z0]],
            [[x0, 0, z1], [x0, h, z1], [x1, h, z1], [x1, 0, z1]],
            [[x0, 0, z0], [x0, h, z0], [x0, h, z1], [x0, 0, z1]],
            [[x1, 0, z0], [x1, 0, z1], [x1, h, z1], [x1, h, z0]],
            [[x0, h, z0], [x1, h, z0], [x1, h, z1], [x0, h, z1]],
        ]
        for q in quads:
            add(q, 7, max(subdiv // 4, 1))

    mesh = Mesh(
        vertices=np.asarray(vertices, np.float32),
        faces=np.asarray(faces, np.int32),
        uvs=np.asarray(uvs, np.float32),
        uv_faces=np.asarray(uv_faces, np.int32),
    )
    # orient only the outer shell inward; interior geometry keeps its winding
    shell = np.zeros(mesh.num_faces, bool)
    shell[:n_outer_faces] = True
    tri = mesh.triangle_corners()
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    to_c = (lo + hi)[None, :] / 2 - tri.mean(axis=1)
    flip = ((n * to_c).sum(-1) < 0) & shell
    mesh.faces[flip] = mesh.faces[flip][:, [0, 2, 1]]
    mesh.uv_faces[flip] = mesh.uv_faces[flip][:, [0, 2, 1]]
    mesh.compute_vertex_normals()

    wall_colors = np.array(
        [[0.60, 0.55, 0.50], [0.85, 0.85, 0.85], [0.70, 0.30, 0.30],
         [0.30, 0.70, 0.35], [0.75, 0.75, 0.45], [0.45, 0.55, 0.80],
         [0.80, 0.72, 0.60], [0.50, 0.35, 0.25]], np.float32)
    wall_rough = np.array([0.5, 0.7, 0.35, 0.6, 0.25, 0.45, 0.55, 0.3], np.float32)

    r = atlas_res
    hdr = np.zeros((r, r, 3), np.float32)
    gt_albedo = np.zeros((r, r, 3), np.float32)
    gt_rough = np.full((r, r, 1), 0.5, np.float32)
    seg = np.zeros((r, r), np.int32)
    for k in range(8):
        rows, cols = _chart_slice(k, r, grid=4)
        noise = 1.0 + 0.1 * rng.standard_normal(
            (rows.stop - rows.start, cols.stop - cols.start, 1))
        hdr[rows, cols] = wall_colors[k] * 0.3 * noise
        gt_albedo[rows, cols] = wall_colors[k]
        gt_rough[rows, cols] = wall_rough[k]
        seg[rows, cols] = k
    # one lamp per room on the ceiling chart (cell 1): u spans the x axis.
    # Lamp size and the wall sconces below are chosen so that EVERY seg
    # class catches specular reflections of some emitter in the exported
    # views — the material-GT renderer (data/export.render_pano_material)
    # needs per-class highlight coverage for the stage-1 roughness
    # propagation to have signal (reference models/loss.py:241-280 pulls
    # each class toward the quantile of ITS OWN highlight region).
    rows, cols = _chart_slice(1, r, grid=4)
    h0 = (rows.start + rows.stop) // 2
    for ufrac in (0.28, 0.78):
        w0 = int(cols.start + ufrac * (cols.stop - cols.start))
        hdr[h0 - r // 20 : h0 + r // 20, w0 - r // 20 : w0 + r // 20] = lamp_radiance
    # wall sconces: one emissive patch per vertical wall chart (cells 2-5),
    # low on the wall so ceiling/walls across the room see its reflection
    for k in (2, 3, 4, 5):
        rows, cols = _chart_slice(k, r, grid=4)
        hh = rows.stop - rows.start
        ww = cols.stop - cols.start
        h1 = rows.start + int(0.3 * hh)
        w1 = cols.start + int(0.62 * ww)
        hdr[h1 - r // 28 : h1 + r // 28, w1 - r // 28 : w1 + r // 28] = lamp_radiance

    return SyntheticScene(
        mesh=mesh, hdr_texture=hdr, gt_albedo=gt_albedo, gt_roughness=gt_rough,
        seg_texture=seg, lamp_radiance=lamp_radiance, size=size,
        # two rooms split by the divider wall at x = dx
        roomseg=make_roomseg(size, lambda X, Z: 1 + (X >= dx)),
    )
