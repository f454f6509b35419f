"""The configurations' scenes: a frozen copy of the port's procedural
scan stand-ins (texir_code_tpu_torch/data/synthetic.py as the port has it
when the benchmark was defined: `make_apartment_scene`,
`make_building_scene` and their helpers; outputs equal for equal
arguments).

The benchmark makes its inputs itself and hands the same arrays to the
program and to the reference, so a later change to the program's scene
generator cannot change the work a cell measures.  Do not edit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Mesh:
    """The generated triangle soup (host numpy)."""

    vertices: np.ndarray  # [V, 3] float32
    faces: np.ndarray     # [F, 3] int32
    uvs: np.ndarray       # [U, 2] float32, v-up
    uv_faces: np.ndarray  # [F, 3] int32

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    def triangle_corners(self) -> np.ndarray:
        """[F, 3, 3] corner positions."""
        return self.vertices[self.faces]

    def compute_vertex_normals(self):
        """Kept for the generator's call; the program computes its own."""


def _cell_uv(face_idx: int, margin: float = 0.02, grid: int = 3) -> np.ndarray:
    """[4, 2] uv corners of face chart `face_idx` in the grid×2 atlas."""
    cx, cy = face_idx % grid, face_idx // grid
    u0 = cx / grid + margin
    u1 = (cx + 1) / grid - margin
    v0 = cy / 2.0 + margin
    v1 = (cy + 1) / 2.0 - margin
    return np.array([[u0, v0], [u1, v0], [u1, v1], [u0, v1]], np.float32)


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


def make_building_scene(
    atlas_res: int = 128,
    lamp_radiance: float = 20.0,
    rooms: Tuple[int, int] = (3, 3),
    room_size: Tuple[float, float, float] = (5.0, 3.0, 5.0),
    seed: int = 666,
    subdiv: int = 8,
    clutter_per_room: int = 2,
) -> SyntheticScene:
    """Scan-scale multi-room building: rooms[0]×rooms[1] grid of rooms
    separated by interior walls with doorways, plus clutter boxes — the
    triangle count and occlusion structure of the reference's real scan
    meshes (reference models/tracer_o3d_irt.py bakes against hundreds of
    thousands of triangles).  subdiv=28 with 3×3 rooms gives 104,076
    triangles (the multi-room scene the JAX package benches).

    Atlas charts (4×2 grid): 0-5 outer shell walls, 6 interior walls,
    7 clutter.  One ceiling lamp per room.  A copy of the JAX package's
    `data/synthetic.py::make_building_scene`: the random draws come in the
    same order, so mesh, atlases and roomseg are equal."""
    rng = np.random.default_rng(seed)
    rx, rz = rooms
    sx = room_size[0] * rx
    sy = room_size[1]
    sz = room_size[2] * rz
    lo = np.zeros(3, np.float32)
    hi = np.asarray([sx, sy, sz], np.float32)

    walls = [
        [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]], [lo[0], lo[1], hi[2]]],
        [[lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]], [hi[0], hi[1], lo[2]]],
        [[lo[0], lo[1], lo[2]], [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]], [hi[0], lo[1], lo[2]]],
        [[lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]], [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]],
        [[lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]], [lo[0], hi[1], hi[2]], [lo[0], hi[1], lo[2]]],
        [[hi[0], lo[1], lo[2]], [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]], [hi[0], lo[1], hi[2]]],
    ]
    vertices, faces, uvs, uv_faces = [], [], [], []

    def add(corners, chart, sub):
        _lattice_quad(vertices, faces, uvs, uv_faces,
                      np.asarray(corners, np.float32), _cell_uv(chart, grid=4),
                      max(sub, 1))

    for k, c in enumerate(walls):
        # floor/ceiling span the whole footprint: scale their tessellation up
        sub = subdiv * max(rx, rz) if k < 2 else subdiv * (rx if k < 4 else rz)
        add(c, k, sub)
    n_outer_faces = len(faces)

    # interior walls along x (between room columns) and z (between rows),
    # each wall segment per room with a doorway gap
    door_w, door_h = 0.9, 2.2
    for i in range(1, rx):
        x = i * room_size[0]
        for j in range(rz):
            z0, z1 = j * room_size[2], (j + 1) * room_size[2]
            zd = z0 + 0.5 * (room_size[2] - door_w) * rng.uniform(0.4, 1.2)
            zd = min(max(zd, z0 + 0.2), z1 - door_w - 0.2)
            # three panels: left of door, right of door, header
            add([[x, 0, z0], [x, sy, z0], [x, sy, zd], [x, 0, zd]], 6, subdiv // 2)
            add([[x, 0, zd + door_w], [x, sy, zd + door_w], [x, sy, z1], [x, 0, z1]],
                6, subdiv // 2)
            add([[x, door_h, zd], [x, sy, zd], [x, sy, zd + door_w],
                 [x, door_h, zd + door_w]], 6, subdiv // 4)
    for j in range(1, rz):
        z = j * room_size[2]
        for i in range(rx):
            x0, x1 = i * room_size[0], (i + 1) * room_size[0]
            xd = x0 + 0.5 * (room_size[0] - door_w) * rng.uniform(0.4, 1.2)
            xd = min(max(xd, x0 + 0.2), x1 - door_w - 0.2)
            add([[x0, 0, z], [x0, sy, z], [xd, sy, z], [xd, 0, z]], 6, subdiv // 2)
            add([[xd + door_w, 0, z], [xd + door_w, sy, z], [x1, sy, z], [x1, 0, z]],
                6, subdiv // 2)
            add([[xd, door_h, z], [xd, sy, z], [xd + door_w, sy, z],
                 [xd + door_w, door_h, z]], 6, subdiv // 4)

    # clutter boxes per room
    for i in range(rx):
        for j in range(rz):
            for _ in range(clutter_per_room):
                cx = (i + rng.uniform(0.15, 0.6)) * room_size[0]
                cz = (j + rng.uniform(0.15, 0.6)) * room_size[2]
                w = 0.4 + 0.5 * rng.random()
                h = 0.4 + 0.7 * rng.random()
                dpt = 0.4 + 0.5 * rng.random()
                x0, x1 = cx, min(cx + w, (i + 1) * room_size[0] - 0.1)
                z0, z1 = cz, min(cz + dpt, (j + 1) * room_size[2] - 0.1)
                quads = [
                    [[x0, 0, z0], [x1, 0, z0], [x1, h, z0], [x0, h, z0]],
                    [[x0, 0, z1], [x0, h, z1], [x1, h, z1], [x1, 0, z1]],
                    [[x0, 0, z0], [x0, h, z0], [x0, h, z1], [x0, 0, z1]],
                    [[x1, 0, z0], [x1, 0, z1], [x1, h, z1], [x1, h, z0]],
                    [[x0, h, z0], [x1, h, z0], [x1, h, z1], [x0, h, z1]],
                ]
                for q in quads:
                    add(q, 7, subdiv // 4)

    mesh = Mesh(
        vertices=np.asarray(vertices, np.float32),
        faces=np.asarray(faces, np.int32),
        uvs=np.asarray(uvs, np.float32),
        uv_faces=np.asarray(uv_faces, np.int32),
    )
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
    # one lamp per room on the ceiling chart: u spans x, v spans z
    rows, cols = _chart_slice(1, r, grid=4)
    for i in range(rx):
        for j in range(rz):
            w0 = int(cols.start + (i + 0.5) / rx * (cols.stop - cols.start))
            h0 = int(rows.start + (j + 0.5) / rz * (rows.stop - rows.start))
            hdr[h0 - r // 64 : h0 + r // 64, w0 - r // 64 : w0 + r // 64] = (
                lamp_radiance
            )

    def room_of_xz(X, Z):
        i = np.clip((X / room_size[0]).astype(int), 0, rx - 1)
        j = np.clip((Z / room_size[2]).astype(int), 0, rz - 1)
        return 1 + i + j * rx

    return SyntheticScene(
        mesh=mesh, hdr_texture=hdr, gt_albedo=gt_albedo, gt_roughness=gt_rough,
        seg_texture=seg, lamp_radiance=lamp_radiance, size=(sx, sy, sz),
        roomseg=make_roomseg((sx, sy, sz), room_of_xz),
    )



def make(config: dict):
    """The scene a configuration names: config["scene"] holds the
    generator's name ("apartment" or "building") and its arguments."""
    spec = dict(config["scene"])
    kind = spec.pop("generator")
    if "rooms" in spec:
        spec["rooms"] = tuple(spec["rooms"])
    fn = {"apartment": make_apartment_scene,
          "building": make_building_scene}[kind]
    return fn(**spec)
