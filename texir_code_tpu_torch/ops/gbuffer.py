"""Primary visibility: ray-cast G-buffers for cube-face cameras.

The port of the JAX package's `ops/gbuffer.py`, which replaces nvdiffrast's
rasterize/interpolate stage (reference models/mat_nvdiffrast.py:119-126).
The reference detaches every G-buffer and disables antialiasing, so one
ray per pixel through the same frustum gives what `dr.rasterize` carries:
exact per-pixel prim ids and barycentrics.  The rays go through the culled
cluster walk (kernel B1 on the card) with one shared origin per row of
pixels, or, for a scene with only a FanScene, through the exhaustive leaf
stream (kernel B2).

Conventions:
  * `mvp` is the transposed (P @ W2C) per face, as the datasets emit it:
    clip_row = vertex_row @ mvp.
  * Image row 0 = top of the face; pixel centres at (j+0.5, i+0.5) map to
    NDC (x=+right, y=+up).
  * Background pixels get position (1,0,0) / normal (1,0,0) — the
    reference's fixed fill.
"""

from __future__ import annotations

import dataclasses

import torch

from texir_code_tpu_torch.ops.raycast import RayHit


@dataclasses.dataclass
class GBuffer:
    """Per-pixel geometry attributes for a stack of F faces at res×res."""

    position: torch.Tensor  # [F, H, W, 3] world-space hit points
    normal: torch.Tensor    # [F, H, W, 3] interpolated shading normals
    uv: torch.Tensor        # [F, H, W, 2] texture coordinates
    prim: torch.Tensor      # [F, H, W]    face index, -1 on background
    mask: torch.Tensor      # [F, H, W, 1] 1.0 where geometry was hit
    t: torch.Tensor         # [F, H, W]    hit distance


@dataclasses.dataclass
class DeviceMesh:
    """Mesh attribute tensors needed for G-buffer interpolation."""

    vertices: torch.Tensor        # [V, 3]
    faces: torch.Tensor           # [F, 3] int64
    vertex_normals: torch.Tensor  # [V, 3]
    triangle_uvs: torch.Tensor    # [F*3, 2] per-corner uvs (o3d layout)

    @classmethod
    def from_mesh(cls, mesh, device) -> "DeviceMesh":
        vn = mesh.vertex_normals
        if vn is None:
            vn = mesh.compute_vertex_normals()
        return cls(
            vertices=torch.as_tensor(mesh.vertices, dtype=torch.float32,
                                     device=device),
            faces=torch.as_tensor(mesh.faces, dtype=torch.int64,
                                  device=device),
            vertex_normals=torch.as_tensor(vn, dtype=torch.float32,
                                           device=device),
            triangle_uvs=torch.as_tensor(mesh.triangle_uvs(),
                                         dtype=torch.float32, device=device),
        )


def pixel_ndc_grid(res: int, device=None):
    """NDC (x, y) at pixel centres, each [res, res]; row 0 = top (y=+1)."""
    idx = torch.arange(res, dtype=torch.float32, device=device) + 0.5
    xs = idx / res * 2.0 - 1.0
    ys = 1.0 - idx / res * 2.0
    y, x = torch.meshgrid(ys, xs, indexing="ij")
    return x, y


def ray_dirs_from_mvp(mvp: torch.Tensor, res: int) -> torch.Tensor:
    """Per-pixel world-space unit ray directions [F, res, res, 3].

    A world direction d projects to pixel (x, y) iff d·(col0 - x·col3) = 0
    and d·(col1 - y·col3) = 0 (columns of the MVP's linear 3×4 block, in
    the row-vector convention).  The ray is the cross product of those two
    plane normals, oriented to positive clip w: exact linear fp32, without
    the ill-conditioned inverse of the MVP (the JAX package's inverse form
    rendered nothing on the TPU and is not ported).

    Args:
        mvp: [F, 4, 4] transposed projection·view matrices.
    """
    x, y = pixel_ndc_grid(res, mvp.device)
    a = mvp[:, :3, :]                        # [F, 3(world), 4(clip)]
    a0 = a[:, None, None, :, 0]
    a1 = a[:, None, None, :, 1]
    a3 = a[:, None, None, :, 3]
    u = a0 - x[None, :, :, None] * a3        # plane of the pixel column
    v = a1 - y[None, :, :, None] * a3        # plane of the pixel row
    d = torch.linalg.cross(u, v, dim=-1)
    w = (d * a3).sum(dim=-1, keepdim=True)   # clip w of the direction
    d = d * torch.sign(w)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def interpolate_attributes(mesh: DeviceMesh, hit: RayHit):
    """Barycentric interpolation of position / normal / uv at hit points
    (dr.interpolate over [position, normal], and the reference's uv rule
    index0·(1-u-v) + index1·u + index2·v).  Returns (position, normal,
    uv), each [B, C]."""
    prim_safe = torch.clamp_min(hit.prim, 0).to(torch.int64)
    tri = mesh.faces[prim_safe]                       # [B, 3]
    w0 = (1.0 - hit.u - hit.v)[..., None]
    w1 = hit.u[..., None]
    w2 = hit.v[..., None]

    def lerp(table, i0, i1, i2):
        return table[i0] * w0 + table[i1] * w1 + table[i2] * w2

    position = lerp(mesh.vertices, tri[:, 0], tri[:, 1], tri[:, 2])
    normal = lerp(mesh.vertex_normals, tri[:, 0], tri[:, 1], tri[:, 2])
    normal = normal / torch.clamp_min(
        torch.linalg.vector_norm(normal, dim=-1, keepdim=True), 1e-12
    )
    base = prim_safe * 3
    uv = lerp(mesh.triangle_uvs, base, base + 1, base + 2)
    return position, normal, uv


def render_gbuffer(
    mesh: DeviceMesh,
    mvp: torch.Tensor,
    cam_position: torch.Tensor,
    res: int,
    cluster_scene,
    fan_block: int = 8,
    exit_rows: int = 0,
    row_width: int = 2048,
    proxy=None,
    occluders=None,
    fan_scene=None,
    rank_mesh=None,
) -> GBuffer:
    """Render cube-face G-buffers by primary-ray casting through the culled
    walk (the JAX package's `cluster_scene` path) or, with no cluster
    scene, the exhaustive fan stream (its `fan_scene` path).

    Args:
        mesh: DeviceMesh attribute tensors.
        mvp: [F, 4, 4] transposed MVPs (dataset convention).
        cam_position: [3].
        res: face resolution (the reference's cube_res = pano_w/4).
        cluster_scene: ops.pallas_culled.ClusterScene of the same mesh.
        fan_block / exit_rows / row_width: the walk's block shape; the
            pixels are cut into rows of the largest multiple of 128 up to
            row_width that divides their count.
        proxy: optional occlusion-proxy ClusterScene whose hits seed the
            walk (exact).
        occluders: optional OccluderSet for exact PVS culling.
        fan_scene: ops.fan_raycast.FanScene of the same mesh, used when
            cluster_scene is None: every pixel ray is tested against every
            leaf row, in rows of 2048 pixels (the knobs above are the
            culled walk's).
        rank_mesh: optional parallel.mesh.DeviceMesh: each rank traces its share
            of the exit groups (whole groups, so every ray keeps its
            candidate list) and the hits are gathered, so the G-buffer
            equals the unsharded one bit for bit on every rank.
    """
    from texir_code_tpu_torch.ops.pallas_culled import cast_fans_culled
    from texir_code_tpu_torch.ops.pallas_fan import cast_ray_fans_pallas

    nfaces = mvp.shape[0]
    flat = ray_dirs_from_mvp(mvp, res).reshape(-1, 3)
    n = flat.shape[0]
    if n % 128:
        raise ValueError(f"{n} pixels are not a multiple of 128")
    if cluster_scene is None and fan_scene is None:
        raise ValueError("render_gbuffer needs a cluster_scene or a fan_scene")
    r_split = min(row_width if cluster_scene is not None else 2048, n)
    while n % r_split:
        r_split -= 128
    rows = n // r_split
    if rank_mesh is not None:
        er = (exit_rows if (exit_rows and fan_block % exit_rows == 0)
              else fan_block) if cluster_scene is not None else 1
        shares = rank_mesh.shares(rows, er)
        mine = shares[rank_mesh.rank]
        flat = flat.reshape(rows, r_split, 3)[mine].reshape(-1, 3)
        rows = mine.stop - mine.start
    origins = tuple(cam_position[k].expand(rows).contiguous()
                    for k in range(3))
    dirs = tuple(flat[:, k].reshape(rows, r_split).contiguous()
                 for k in range(3))
    if rows == 0:
        hit = RayHit(t=flat.new_empty((0,)),
                     prim=torch.empty((0,), dtype=torch.int32,
                                      device=flat.device),
                     u=flat.new_empty((0,)), v=flat.new_empty((0,)))
    elif cluster_scene is not None:
        hit = cast_fans_culled(
            cluster_scene, origins, dirs, t_min=1e-6, fan_block=fan_block,
            exit_rows=exit_rows, emit_prim=True, proxy=proxy,
            occluders=occluders,
        )
    else:
        hit = cast_ray_fans_pallas(fan_scene, origins, dirs, t_min=1e-6)
    hit = RayHit(t=hit.t.reshape(-1), prim=hit.prim.reshape(-1),
                 u=hit.u.reshape(-1), v=hit.v.reshape(-1))
    if rank_mesh is not None:
        counts = [(s.stop - s.start) * r_split for s in shares]
        hit = RayHit(*(rank_mesh.all_gather_rows(a, counts) for a in
                       (hit.t, hit.prim, hit.u, hit.v)))

    valid = hit.prim >= 0
    position, normal, uv = interpolate_attributes(mesh, hit)
    # the reference's background fill: position (1,0,0), normal (1,0,0)
    bg = torch.tensor([1.0, 0.0, 0.0], device=position.device)
    vmask = valid[:, None]
    position = torch.where(vmask, position, bg)
    normal = torch.where(vmask, normal, bg)
    uv = torch.where(vmask, uv, torch.zeros_like(uv))
    shp = (nfaces, res, res)
    return GBuffer(
        position=position.reshape(shp + (3,)),
        normal=normal.reshape(shp + (3,)),
        uv=uv.reshape(shp + (2,)),
        prim=torch.where(valid, hit.prim, -1).reshape(shp),
        mask=valid.to(torch.float32).reshape(shp + (1,)),
        t=hit.t.reshape(shp),
    )


def cube_face_w2c(extrinsic: torch.Tensor) -> torch.Tensor:
    """Six world→camera matrices [6, 4, 4] for a cube rig at the
    camera-to-world `extrinsic` [4, 4] (columns Right, Up, Front | pos),
    in the Pano2Cube face order [left, front, right, back, top, bottom]."""
    e = extrinsic.to(torch.float32)
    right, up_col, front = e[0:3, 0], e[0:3, 1], e[0:3, 2]

    def compose(r, u, f):
        m = e.clone()
        m[0:3, 0] = r
        m[0:3, 1] = u
        m[0:3, 2] = f
        return torch.linalg.inv(m)

    up = torch.linalg.cross(front, right, dim=-1)
    faces = [
        compose(front, up_col, -right),   # 0 left
        torch.linalg.inv(e),              # 1 front
        compose(-front, up_col, right),   # 2 right
        compose(-right, up_col, -front),  # 3 back
        compose(right, -front, up),       # 4 top (image-up = -front)
        compose(right, front, -up),       # 5 bottom (image-up = +front)
    ]
    return torch.stack(faces, dim=0)


def gl_projection(fov_deg: float = 90.0, n: float = 1e-4,
                  f: float = 100.0) -> torch.Tensor:
    """The reference's +z-forward projection (datasets/dataset.py:544-549)."""
    half = torch.deg2rad(torch.tensor(fov_deg, dtype=torch.float32)) / 2.0
    t = float(1.0 / torch.tan(half))
    return torch.tensor(
        [
            [t, 0.0, 0.0, 0.0],
            [0.0, t, 0.0, 0.0],
            [0.0, 0.0, (f + n) / (f - n), -(2 * f * n) / (f - n)],
            [0.0, 0.0, 1.0, 0.0],
        ],
        dtype=torch.float32,
    )


def cube_mvp(extrinsic, fov_deg: float = 90.0) -> torch.Tensor:
    """[6, 4, 4] transposed MVPs (the dataset item's `cam_to_world` key),
    computed on the CPU in float32."""
    w2c = cube_face_w2c(torch.as_tensor(extrinsic, dtype=torch.float32))
    mvp = torch.einsum("jk,fkl->fjl", gl_projection(fov_deg), w2c)
    return mvp.transpose(1, 2).contiguous()
