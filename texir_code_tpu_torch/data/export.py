"""Render a synthetic scene into the reference's on-disk dataset layout.

The port of the JAX package's `data/export.py`: a complete "scan" dataset
— HDR panos photographed with the port's own ray tracer, segmentation
panos, extrinsics, mesh + atlas (and room segmentation for multi-room
scenes) — so the Mat stage runs hermetically on the layout the reference
expects (see data/datasets.py).

The pano rays go through the culled cluster walk with shared origins (one
camera per pano); the JAX exporter uses its BVH traversal, and both find
the same closest hits.  Two deliberate differences: the LDR preview is
written as `derived/<id>/panoImage_orig.png` (there is no JPEG encoder
without OpenCV; the dataset reads either, and a JPEG's pixels are never
used), and `gt_render="material"` is not ported.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.geometry.obj import save_obj

ROW_WIDTH = 512  # pano rays per walk row


def pano_dirs(h: int, w: int, rotation: Optional[np.ndarray] = None) -> np.ndarray:
    """[h, w, 3] equirect directions (θ over width ∈ [-π, π], φ over height
    ∈ [π/2, -π/2] — the Cube2Pano convention)."""
    theta, phi = np.meshgrid(
        np.linspace(-np.pi, np.pi, w, dtype=np.float32),
        np.linspace(0.5 * np.pi, -0.5 * np.pi, h, dtype=np.float32),
    )
    d = np.stack(
        [np.cos(phi) * np.sin(theta), np.sin(phi), np.cos(phi) * np.cos(theta)],
        axis=-1,
    )
    if rotation is not None:
        d = d @ np.asarray(rotation, np.float32).T
    return d.astype(np.float32)


def _trace_pano(cluster_scene, cam_position, res, t_min: float):
    """Closest hits of one camera's pano rays (RayHit of [h*w] tensors)."""
    from texir_code_tpu_torch.ops.pallas_culled import cast_fans_culled
    from texir_code_tpu_torch.ops.raycast import RayHit

    h, w = res
    dev = cluster_scene.rows3.device
    d = torch.from_numpy(pano_dirs(h, w).reshape(-1, 3)).to(dev)
    n = d.shape[0]
    pad = (-n) % ROW_WIDTH
    d = torch.nn.functional.pad(d, (0, 0, 0, pad))
    rows = (n + pad) // ROW_WIDTH
    cam = torch.as_tensor(np.asarray(cam_position, np.float32), device=dev)
    hit = cast_fans_culled(
        cluster_scene, tuple(cam[k].expand(rows).contiguous() for k in range(3)),
        tuple(d[:, k].reshape(rows, ROW_WIDTH).contiguous() for k in range(3)),
        t_min=t_min, emit_prim=True,
    )
    return RayHit(*(a.reshape(-1)[:n] for a in (hit.t, hit.prim, hit.u, hit.v)))


def render_pano(tbl, cluster_scene, cam_position, res: Tuple[int, int]) -> np.ndarray:
    """HDR "photograph": per-pixel TBL radiance along pano rays [h, w, 3]
    (rays from t 0, radiance zero for hits nearer than 1e-5)."""
    from texir_code_tpu_torch.models.tbl import radiance_from_hit

    hit = _trace_pano(cluster_scene, cam_position, res, t_min=0.0)
    rgb = radiance_from_hit(tbl, hit, t_valid=1e-5)
    return torch.stack(rgb, dim=-1).cpu().numpy().reshape(res + (3,))


def render_seg_pano(tbl, cluster_scene, seg_texture: np.ndarray, cam_position,
                    res) -> np.ndarray:
    """Per-pixel segmentation id pano [h, w]: nearest atlas lookup at the
    hit's uv, 0 on a miss."""
    hit = _trace_pano(cluster_scene, cam_position, res, t_min=1e-5)
    prim = hit.prim.cpu().numpy()
    u = np.clip(hit.u.cpu().numpy(), 0, 1)
    v = np.clip(hit.v.cpu().numpy(), 0, 1)
    uv_u = tbl.uv_u.cpu().numpy()
    uv_v = tbl.uv_v.cpu().numpy()
    p = np.maximum(prim, 0)
    uu = uv_u[p * 3] * (1 - u - v) + uv_u[p * 3 + 1] * u + uv_u[p * 3 + 2] * v
    vv = uv_v[p * 3] * (1 - u - v) + uv_v[p * 3 + 1] * u + uv_v[p * 3 + 2] * v
    r = seg_texture.shape[0]
    rows = np.clip((vv * r).astype(int), 0, r - 1)
    cols = np.clip((uu * seg_texture.shape[1]).astype(int), 0,
                   seg_texture.shape[1] - 1)
    seg = seg_texture[rows, cols].astype(np.float32)
    seg[prim < 0] = 0
    return seg.reshape(res)


def _as_u8(ids: np.ndarray, what: str) -> np.ndarray:
    """Integer ids as uint8 image values; ids above 255 would wrap."""
    if ids.size and (ids.min() < 0 or ids.max() > 255):
        raise ValueError(f"{what} ids must lie in [0, 255] for an 8-bit PNG")
    return ids.astype(np.uint8)


def export_reference_layout(
    scene,
    out_dir: str,
    n_views: int = 4,
    pano_res: Tuple[int, int] = (128, 256),
    with_gt: bool = True,
    gt_render: str = "radiance",
    cameras=None,
    device="cuda",
) -> str:
    """Write the reference dataset layout; returns path_mesh (out1.obj).

    gt_render: 'radiance' — photos are plain TBL lookups (view-independent:
    fine for the pipeline, but without specular signal).  'material' (the
    JAX package renders photos through the forward material model) is not
    ported (ROADMAP.md queue A item 12)."""
    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.models.tbl import build_tbl
    from texir_code_tpu_torch.ops.fan_raycast import FanScene
    from texir_code_tpu_torch.ops.pallas_culled import ClusterScene

    if gt_render != "radiance":
        raise NotImplementedError(
            f"gt_render={gt_render!r}: the material-rendered export is not "
            f"ported yet (ROADMAP.md queue A item 12)"
        )
    dev = resolve_device(device)
    root = out_dir
    mesh_dir = os.path.join(root, "mesh")
    for sub in ("info", "derived", "hdr", "mesh"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    path_mesh = os.path.join(mesh_dir, "out1.obj")
    save_obj(path_mesh, scene.mesh)
    hdrio.write_hdr(os.path.join(mesh_dir, "hdr_texture.hdr"),
                    scene.hdr_texture, flip=True)

    if scene.roomseg is not None:
        # reference roomseg assets (utils/general.py:115-125): occupancy-
        # grid meta "scale w h x_min z_min" + uchar room-id image
        rdir = os.path.join(root, "roomseg")
        os.makedirs(rdir, exist_ok=True)
        scale, w, h, x_min, z_min, room_img = scene.roomseg
        with open(os.path.join(rdir, "originOccupancyGrid_f0.meta"), "w") as f:
            f.write(f"{scale} {int(w)} {int(h)} {x_min} {z_min}\n")
        hdrio.write_png(os.path.join(rdir, "roomSegs_uchar_f0.png"),
                        _as_u8(np.asarray(room_img), "room"))

    tbl = build_tbl(scene.mesh, scene.hdr_texture, device=dev)
    flat = build_bvh(scene.mesh.vertices, scene.mesh.faces)
    fan = FanScene.from_flat(flat, triangle_uvs=scene.mesh.triangle_uvs())
    clusters = ClusterScene.from_fan(fan, lb=8, dense=True, device=dev)
    cams = (np.asarray(cameras, np.float32) if cameras is not None
            else scene.camera_positions(n_views))
    n_views = len(cams)
    ids = [f"view{i:03d}" for i in range(n_views)]

    with open(os.path.join(root, "info", "aligned.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    with open(os.path.join(root, "info", "final_extrinsics.txt"), "w") as f:
        f.write(f"{n_views} views\n")
        for c in cams:
            e = np.eye(4, dtype=np.float32)
            e[0:3, 3] = c
            for row in e:
                f.write(" ".join(f"{x:.6f}" for x in row) + "\n")

    for vid, cam in zip(ids, cams):
        os.makedirs(os.path.join(root, "derived", vid), exist_ok=True)
        os.makedirs(os.path.join(root, "hdr", vid), exist_ok=True)
        color = render_pano(tbl, clusters, cam, pano_res)
        hdrio.write_hdr(os.path.join(root, "hdr", vid, "ccm.hdr"), color)
        # the LDR preview (full coverage: no alpha, like the JAX exporter's
        # JPEG)
        hdrio.write_png(os.path.join(root, "derived", vid,
                                     "panoImage_orig.png"),
                        hdrio.tonemap_to_ldr(color))
        seg = render_seg_pano(tbl, clusters, scene.seg_texture, cam, pano_res)
        hdrio.write_png(os.path.join(root, "derived", vid,
                                     "panoImage_gray.png"),
                        _as_u8(seg, "segmentation"))

    if with_gt:
        gt_dir = os.path.join(root, "gt")
        os.makedirs(gt_dir, exist_ok=True)
        # albedo in sRGB, so the dataset's **2.2 roundtrips
        hdrio.write_hdr(os.path.join(gt_dir, "albedo.hdr"),
                        np.power(np.clip(scene.gt_albedo, 0, 1), 1 / 2.2))
        hdrio.write_hdr(os.path.join(gt_dir, "roughness.hdr"),
                        scene.gt_roughness)
    return path_mesh
