"""Render a synthetic scene into the reference's on-disk dataset layout.

The port of the JAX package's `data/export.py`: a complete "scan" dataset
— HDR panos photographed with the port's own ray tracer, segmentation
panos, extrinsics, mesh + atlas (and room segmentation for multi-room
scenes) — so the Mat stage runs hermetically on the layout the reference
expects (see data/datasets.py).

The radiance panos' rays go through the culled cluster walk with shared
origins (one camera per pano); the JAX exporter uses its BVH traversal,
and both find the same closest hits.  `gt_render="material"` photographs
each view through the forward material model (`render_pano_material`):
the primary hit from the BVH traversal, the GT IrT baked by the port's
baker over a ClusterScene (kernel B1's bake mode on the card), and the
specular rays through the culled walk with per-ray origins.  One
deliberate difference: the LDR preview is written as
`derived/<id>/panoImage_orig.png` (there is no JPEG encoder without
OpenCV; the dataset reads either, and a JPEG's pixels are never used).
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


def render_pano_material(
    mesh,
    tbl,
    irt_texture: np.ndarray,
    gt_albedo: np.ndarray,
    gt_roughness: np.ndarray,
    cam_position,
    res: Tuple[int, int],
    spp: int = 256,
    seed: int = 0,
    fan_scene=None,
    cluster_scene=None,
    chunk: int = 16384,
    samples: Optional[torch.Tensor] = None,
    pixels: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """GT pano [h, w, 3] rendered through the forward material model.

    Diffuse = IrT·albedo/π; specular = GGX importance-sampled Cook-Torrance
    MC against the TBL — the shading the Mat stages optimize through
    (reference models/mat_nvdiffrast.py:203-279), at the GT atlases with
    high spp, so the photos carry view-dependent specular signal and the
    GT atlases are an optimum of the Mat inverse problem.  The primary hit
    is the BVH traversal's (t_min 1e-5); the specular rays go through
    query_tbl_auto: the culled walk with per-ray origins when a cluster
    scene is given (exact radiance_from_hit fetch), the BVH otherwise.

    Args:
        tbl: TBL with a BVH, on the device the render runs on.
        irt_texture / gt_albedo / gt_roughness: [H, W, C] atlases (v-up).
        spp: specular samples a pixel.
        seed: the draws are keyed by (seed, pixel id), whatever the chunk.
        samples: optional [h·w, spp, 2] uniforms replacing the draws
            (parity tests inject the JAX exporter's).
        pixels: optional raster pixel ids [p0, p1): only they are
            rendered ([p1 - p0, 3]), with the same draws as in the full
            pano.
    """
    from texir_code_tpu_torch.models.tbl import query_tbl_auto
    from texir_code_tpu_torch.ops.gbuffer import (
        DeviceMesh,
        interpolate_attributes,
    )
    from texir_code_tpu_torch.ops.raycast import cast_rays_soa
    from texir_code_tpu_torch.ops.sampling import generate_dir_soa, reflect_soa
    from texir_code_tpu_torch.ops.shading import specular_estimator_soa
    from texir_code_tpu_torch.ops.texture import bilinear_sample

    h, w = res
    dev = tbl.planes[0].device
    dm = DeviceMesh.from_mesh(mesh, dev)
    p0, p1 = pixels if pixels is not None else (0, h * w)
    d_all = torch.from_numpy(pano_dirs(h, w).reshape(-1, 3)[p0:p1]).to(dev)
    n_all = d_all.shape[0]
    cam = torch.as_tensor(np.asarray(cam_position, np.float32), device=dev)

    def atlas(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    alb_t, rgh_t, irt_t = atlas(gt_albedo), atlas(gt_roughness), atlas(
        irt_texture)
    out = torch.empty((n_all, 3), dtype=torch.float32, device=dev)
    for i0 in range(0, n_all, chunk):
        i1 = min(i0 + chunk, n_all)
        n = i1 - i0
        dirs = tuple(d_all[i0:i1, k] for k in range(3))
        hit = cast_rays_soa(tbl.bvh, tuple(cam[k].expand(n) for k in range(3)),
                            dirs, t_min=1e-5)
        valid = hit.prim >= 0
        position, normal, uv = interpolate_attributes(dm, hit)
        albedo = bilinear_sample(alb_t, uv)
        rough = bilinear_sample(rgh_t, uv)[:, 0]
        irr = bilinear_sample(irt_t, uv)
        diffuse = irr * albedo / np.pi

        # the trainers shade from position + 1e-2·normal (reference :151)
        pts = position + 1e-2 * normal
        view_v = cam[None, :] - pts
        view_v = view_v / torch.clamp_min(
            torch.linalg.vector_norm(view_v, dim=-1, keepdim=True), 1e-4)
        n_soa = tuple(normal[:, k] for k in range(3))
        v_soa = tuple(view_v[:, k] for k in range(3))
        half = generate_dir_soa(
            n_soa, spp, mode="importance", roughness=rough,
            pre_mode="independent",
            samples=(None if samples is None
                     else samples[p0 + i0:p0 + i1].to(dev)),
            row_ids=torch.arange(p0 + i0, p0 + i1, device=dev), seed=seed,
        )
        light_dirs, _ = reflect_soa(v_soa, half)
        spec_o = tuple(pts[:, k:k + 1].expand(n, spp) for k in range(3))
        lighting = query_tbl_auto(tbl, spec_o, light_dirs, cluster_scene,
                                  fan_scene=fan_scene)
        spec = specular_estimator_soa(lighting, half, n_soa, v_soa,
                                      light_dirs, rough)
        rgb = diffuse + torch.stack(spec, dim=-1) / spp
        out[i0:i1] = torch.where(valid[:, None], rgb, torch.zeros_like(rgb))
    out = out.cpu().numpy()
    return out if pixels is not None else out.reshape(h, w, 3)


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
    gt_spp: int = 256,
    irt_spp: int = 512,
    cameras=None,
    device="cuda",
) -> str:
    """Write the reference dataset layout; returns path_mesh (out1.obj).

    gt_render: 'radiance' — photos are plain TBL lookups (view-independent:
    fine for the pipeline, but without specular signal, so gt_roughness
    cannot be recovered from them); 'material' — the GT IrT is baked at
    irt_spp (written as mesh/gt_irt.hdr, gutters padded) and each photo is
    rendered through the forward material model from the GT atlases at
    gt_spp specular samples (render_pano_material), the synthetic-data
    contract the Mat-syn metrics assume.  The material mode's draws are
    the JAX exporter's seeds: view i with seed i, the GT IrT bake from a
    generator seeded 7.  `export_reference_layout.timings` holds the last
    call's bake and per-view seconds."""
    import time

    from texir_code_tpu_torch.geometry.bvh import build_bvh
    from texir_code_tpu_torch.models.tbl import build_tbl_from_flat
    from texir_code_tpu_torch.ops.fan_raycast import FanScene
    from texir_code_tpu_torch.ops.pallas_culled import ClusterScene

    if gt_render not in ("radiance", "material"):
        raise ValueError(f"unknown gt_render: {gt_render!r}")
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

    flat = build_bvh(scene.mesh.vertices, scene.mesh.faces)
    tbl = build_tbl_from_flat(flat, scene.mesh, scene.hdr_texture, device=dev)
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

    timings = {"bake_s": 0.0, "views_s": []}
    gt_irt = mat_clusters = None
    if gt_render == "material":
        from texir_code_tpu_torch.models.tracer_irt import (
            IrradianceTextureBaker,
            bake_geometry_textures,
        )
        from texir_code_tpu_torch.ops.postprocess import pad_texture

        t0 = time.time()
        # the JAX exporter's scene for its device kernels: lb 4, dense
        mat_clusters = ClusterScene.from_fan(fan, lb=4, dense=True,
                                             device=dev)
        baker = IrradianceTextureBaker(tbl, spp=irt_spp, texel_batch=4096,
                                       cluster_scene=mat_clusters)
        geom = bake_geometry_textures(scene.mesh, scene.hdr_texture.shape[0])
        gt_irt = pad_texture(
            baker.bake(geom, torch.Generator().manual_seed(7)),
            geom.valid)
        timings["bake_s"] = time.time() - t0
        hdrio.write_hdr(os.path.join(mesh_dir, "gt_irt.hdr"), gt_irt,
                        flip=True)

    for vid, cam in zip(ids, cams):
        os.makedirs(os.path.join(root, "derived", vid), exist_ok=True)
        os.makedirs(os.path.join(root, "hdr", vid), exist_ok=True)
        t0 = time.time()
        if gt_render == "material":
            color = render_pano_material(
                scene.mesh, tbl, gt_irt, scene.gt_albedo, scene.gt_roughness,
                cam, pano_res, spp=gt_spp, seed=int(vid[-3:]),
                cluster_scene=mat_clusters)
        else:
            color = render_pano(tbl, clusters, cam, pano_res)
        timings["views_s"].append(time.time() - t0)
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
    export_reference_layout.timings = timings
    return path_mesh


export_reference_layout.timings = {"bake_s": 0.0, "views_s": []}
