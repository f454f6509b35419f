"""MaterialModel — the TexIR SVBRDF texture optimizer (the flagship model).

The port of the JAX package's `models/material.py` (reference
models/mat_nvdiffrast.py:35-320) on one device.  One forward pass renders
a camera's six cube faces:

    G-buffer (primary rays through the culled walk)  [was dr.rasterize]
    mip-sampled albedo / roughness / IrT fetches      [was dr.texture ×4]
    diffuse  = IrT · albedo / π
    specular = GGX importance MC against the TBL, its rays traced by the
               culled walk with per-ray origins      [was query_irf]

With `model.cluster_scene = None` (as in the JAX package) both traces run
the exhaustive leaf stream over the model's FanScene instead
(ops.pallas_fan; the proxy and the occluders apply only to the walk).

Stage schedule (reference forward, models/mat_nvdiffrast.py:141-190):
    -1: VHL pass — emitter restricted to light-source texels, albedo 0,
        roughness 0.01 → a virtual-highlight image that builds the masks.
     0: Lambertian albedo init: rgb = irr·albedo/π.
     1: roughness only: albedo detached, non-mipmapped roughness shades,
        highlight-masked loss.
     2: joint: both live, mipmapped.

Only the texture fetches and the BRDF chain carry gradients; G-buffers and
the traced light directions are detached where the reference detaches.

Random numbers: the per-pixel toroidal sample shift (and, with the
stochastic sampling knobs, the mip-level and bilinear-corner uniforms) is
a counter hash of (seed, global pixel id) — `draw_spec_shift` — so a
pixel's draw does not depend on batching.  Torch cannot reproduce JAX's
threefry keys; parity tests pass JAX's own draws as `spec_shift`.

Multi-device (parallel/, one rank per device), as the JAX package:
  * `spmd_mesh` (data parallel): each rank traces its share of the
    G-buffer's exit groups and gathers the hits, then shades its share of
    the pixels (cut at the specular walk's exit groups, so every ray keeps
    its unsharded candidate list) with draws keyed by the global pixel id;
    `all_gather_rows` assembles the outputs, and its backward hands each
    rank its own pixels' cotangent.  The caller all-reduces the atlas
    gradients (`DeviceMesh.all_reduce_grads`).  `shade_chunk` chunks a
    rank's share (the JAX package does not chunk under a mesh).
  * `atlas_mesh` (tensor parallel): `params` hold this rank's rows of
    each atlas and the three material lookups go through
    `parallel.atlas_tp.tp_sample_materials` (exact trilinear: the
    stochastic knobs draw nothing); the rest of the step is replicated.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.ops import shading
from texir_code_tpu_torch.ops.chunking import map_chunked
from texir_code_tpu_torch.ops.gbuffer import DeviceMesh, render_gbuffer
from texir_code_tpu_torch.ops.sampling import (
    TINY_NUMBER,
    generate_dir_soa,
    hammersley,
    hash_uniform,
    reflect_soa,
)
from texir_code_tpu_torch.ops.texture import (
    bilinear_sample,
    build_mip_pyramid,
    compute_lod,
    texture_sample,
)


@dataclasses.dataclass
class MaterialParams:
    """Learnable SVBRDF atlases."""

    albedo: torch.Tensor     # [Ra, Ra, 3], init 0.5 (reference :68)
    roughness: torch.Tensor  # [Rr, Rr, 1], init 0.1 (reference :69)


# Conf-tunable knobs (models.render.* in .conf files), as the JAX package's.
RENDER_KNOBS = (
    "spec_fan_block", "spec_exit_rows", "spec_row_width",
    "spec_two_pass_cut", "spec_two_pass_cap",
    "proxy_k",
    "use_occluders",
    "mip_stochastic",
    "bilinear_stochastic",
    "gbuf_fan_block", "gbuf_exit_rows", "gbuf_row_width",
    "specular_fetch",
    "shade_chunk",
)

def render_knobs_from_conf(conf) -> Dict:
    """Collect the models.render.* knobs (and cluster_lb) from a conf."""
    knobs = {}
    for name in RENDER_KNOBS:
        val = conf.get(f"models.render.{name}", None)
        if val is not None:
            knobs[name] = val
    lb = conf.get("models.render.cluster_lb", None)
    if lb is not None:
        knobs["cluster_lb"] = int(lb)
    return knobs


def init_material_params(albedo_res: int = 2048, roughness_res: int = 4096,
                         device="cuda") -> MaterialParams:
    dev = resolve_device(device)
    return MaterialParams(
        albedo=torch.full((albedo_res, albedo_res, 3), 0.5, device=dev),
        roughness=torch.full((roughness_res, roughness_res, 1), 0.1,
                             device=dev),
    )


def clamp_material_params(params: MaterialParams, rough_min: float = 1e-2,
                          rough_max: float = 0.8) -> MaterialParams:
    """Post-step projection (reference trainer/train_material.py:458,592):
    roughness ∈ [1e-2, 0.8], albedo ≥ 0."""
    return MaterialParams(
        albedo=torch.clamp_min(params.albedo, 0.0),
        roughness=torch.clamp(params.roughness, rough_min, rough_max),
    )


class MaterialModel:
    """Differentiable cube-map SVBRDF renderer over a fixed scene whose
    tensors live on one device."""

    def __init__(
        self,
        mesh,
        hdr_texture: np.ndarray,
        irt_texture: np.ndarray,
        pano_res: Tuple[int, int] = (256, 512),
        sample_light: Tuple[int, int] = (32, 16),
        sample_type: Tuple[str, str] = ("uniform", "importance"),
        hdr_exposure: float = 0.0,
        max_mip_level: Optional[int] = None,
        leaf_width: int = 4,
        spmd_mesh=None,
        atlas_mesh=None,
        cluster_lb: int = 8,
        render_knobs: Optional[Dict] = None,
        device="cuda",
    ):
        """Args mirror the reference config knobs:

        pano_res: train.pano_img_res; cube_res = pano_res[1]//4.
        sample_light: (diffuse spp, specular spp) — diffuse unused with IrT.
        hdr_exposure: scales the TBL atlas by 2**hdr_exposure.
        max_mip_level: defaults to get_mip_level(8192)=13.
        spmd_mesh: optional parallel.mesh.DeviceMesh — the pixel axis is
            split over its ranks (data parallel; parameters replicated).
        atlas_mesh: optional parallel.mesh.DeviceMesh — the material
            atlases are row-sharded over its ranks (tensor parallel).
            Mutually exclusive with spmd_mesh.
        device: where every scene tensor lives (default: the card).
        """
        from texir_code_tpu_torch.geometry.bvh import build_bvh
        from texir_code_tpu_torch.models.tbl import (
            build_tbl_from_flat,
            rgbe_prefilter,
            vhl_texture,
        )
        from texir_code_tpu_torch.ops.fan_raycast import FanScene
        from texir_code_tpu_torch.ops.pallas_culled import ClusterScene

        if spmd_mesh is not None and atlas_mesh is not None:
            raise ValueError("spmd_mesh and atlas_mesh are mutually exclusive")
        self.spmd_mesh = spmd_mesh
        self.atlas_mesh = atlas_mesh
        self.device = resolve_device(device)
        self.cube_res = int(pano_res[1] // 4)
        self.sample_light = tuple(sample_light)
        self.sample_type = tuple(sample_type)
        self.hdr_exposure = float(hdr_exposure)
        self.max_mip_level = (
            max_mip_level if max_mip_level is not None
            else shading.get_mip_level(8192)
        )
        self.mesh = mesh
        self.device_mesh = DeviceMesh.from_mesh(mesh, self.device)

        flat = build_bvh(mesh.vertices, mesh.faces, leaf_width=leaf_width)
        self.tbl = build_tbl_from_flat(flat, mesh, hdr_texture, hdr_exposure,
                                       device=self.device)
        self.tbl_vhl = self.tbl.with_texture(
            vhl_texture(self.tbl.texture, hdr_exposure)
        )
        self.fan_scene = FanScene.from_flat(
            flat, triangle_uvs=mesh.triangle_uvs())
        cluster_lb = (render_knobs or {}).get("cluster_lb", cluster_lb)
        self.cluster_scene = ClusterScene.from_fan(
            self.fan_scene, lb=cluster_lb, dense=True, device=self.device
        )
        # the JAX package's defaults (models/material.py:205-247)
        self.specular_fetch = "prefiltered"
        self.spec_fan_block = 8
        self.spec_exit_rows = 1
        self.spec_row_width = 1024
        self.spec_two_pass_cut = None
        self.spec_two_pass_cap = 0.125
        self.gbuf_fan_block = 8
        self.gbuf_exit_rows = 0
        self.gbuf_row_width = 2048
        self.proxy_k = 0
        self.use_occluders = False
        self.mip_stochastic = False
        self.bilinear_stochastic = False
        # pixel-chunked shading for high-spp evaluation (the reference's
        # split_input, utils/general.py:28-58); None = one shot
        self.shade_chunk: Optional[int] = None
        for k, v in (render_knobs or {}).items():
            if k == "cluster_lb":
                continue
            if not hasattr(self, k):
                raise ValueError(f"unknown render knob: {k}")
            setattr(self, k, v)
        if self.bilinear_stochastic and not self.mip_stochastic:
            raise ValueError("bilinear_stochastic requires mip_stochastic=True")
        if self.specular_fetch not in ("prefiltered", "exact"):
            raise ValueError(f"unknown specular_fetch {self.specular_fetch!r}")
        if self.atlas_mesh is not None and (self.mip_stochastic
                                            or self.bilinear_stochastic):
            warnings.warn(
                "stochastic sampling knobs are ignored under atlas tensor-"
                "parallelism: tp_sample_materials is exact-trilinear (no "
                "rng); the forward skips drawing the unused uniforms")

        self._rgbe_pre = rgbe_prefilter(self.tbl.planes, 2)
        self._rgbe_pre_vhl = rgbe_prefilter(self.tbl_vhl.planes, 2)
        self.irt = torch.as_tensor(np.asarray(irt_texture, np.float32),
                                   device=self.device)
        # the IrT atlas is constant during Mat training: its pyramid is
        # built once (albedo/roughness pyramids are built per step, they
        # are differentiable functions of the parameters)
        self.irt_pyramid = build_mip_pyramid(self.irt, None)
        # occlusion proxy: the k largest triangles, traced first to seed
        # the G-buffer's and the specular trace's walks (exact)
        self.proxy_scene = (
            ClusterScene.proxy_from_fan(self.fan_scene, k=int(self.proxy_k),
                                        device=self.device)
            if self.proxy_k else None
        )
        self.occluders = None
        if self.use_occluders:
            from texir_code_tpu_torch.geometry.occluders import extract_occluders

            self.occluders = extract_occluders(mesh, device=self.device)

    # -- random draws ------------------------------------------------------

    @property
    def num_uniforms(self) -> int:
        """Uniforms per pixel: the two sample-shift components, then the
        stochastic-LOD uniform, then the two bilinear-corner uniforms (none
        of the three under atlas tensor parallelism)."""
        if self.atlas_mesh is not None:
            return 2
        if self.bilinear_stochastic:
            return 5
        return 3 if self.mip_stochastic else 2

    def draw_spec_shift(self, seed: int, num_pixels: int,
                        ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, num_uniforms] per-pixel uniforms, a counter hash of (seed,
        global pixel id, column); the pixel ids are 0..num_pixels-1 unless
        `ids` gives them."""
        if ids is None:
            ids = torch.arange(num_pixels, device=self.device)
        cols = torch.arange(self.num_uniforms, device=self.device)
        return hash_uniform(seed, ids, cols)

    def atlas_shape(self, atlas: torch.Tensor) -> Tuple[int, int]:
        """(H, W) of the whole atlas whose tensor (under atlas tensor
        parallelism: this rank's rows) is `atlas`."""
        rows = atlas.shape[0] * (self.atlas_mesh.size if self.atlas_mesh
                                 else 1)
        return rows, atlas.shape[1]

    def pixel_shares(self, b: int):
        """(every rank's slice of the b pixels, the specular walk's row
        width) under spmd_mesh: shares cut at the walk's exit groups, so
        every ray keeps its unsharded candidate list."""
        from texir_code_tpu_torch.models.tbl import stream_group_rays

        s = self.sample_light[1]
        group, row = stream_group_rays(b * s, self.spec_row_width,
                                       self.spec_fan_block,
                                       self.spec_exit_rows)
        return self.spmd_mesh.shares(b, math.lcm(group, s) // s), row

    # -- the forward pass --------------------------------------------------

    def precompute_view(self, params: MaterialParams, mvp, cam_position):
        """Per-view constants of a training step: the primary G-buffer and
        the mip LODs depend only on the camera, so the trainer computes
        them once per view.  `params` gives only the atlas shapes."""
        mvp = torch.as_tensor(mvp, dtype=torch.float32, device=self.device)
        cam = torch.as_tensor(cam_position, dtype=torch.float32,
                              device=self.device)
        with torch.no_grad():
            g = render_gbuffer(
                self.device_mesh, mvp, cam, self.cube_res, self.cluster_scene,
                fan_block=self.gbuf_fan_block, exit_rows=self.gbuf_exit_rows,
                row_width=self.gbuf_row_width, proxy=self.proxy_scene,
                occluders=self.occluders, fan_scene=self.fan_scene,
                rank_mesh=self.spmd_mesh,
            )
            uv_img = g.uv
            f, h, w, _ = g.normal.shape
            b = f * h * w
            lod = {
                name: compute_lod(uv_img, *hw).reshape(b)
                for name, hw in (("lod_a", self.atlas_shape(params.albedo)),
                                 ("lod_r", self.atlas_shape(params.roughness)),
                                 ("lod_i", self.irt.shape[:2]))
            }
        return dict(uv=uv_img.reshape(b, 2), normal=g.normal,
                    position=g.position, mask=g.mask, **lod)

    def _forward(self, params: MaterialParams, mvp, cam_position, stage: int,
                 seed: int = 0, view=None, spec_shift=None):
        """Render one camera.

        Args:
            params: MaterialParams (tensors on the model's device).
            mvp: [6, 4, 4] transposed MVPs; cam_position: [3].
            stage: -1 (VHL) / 0 / 1 / 2.
            seed: keys the per-pixel draws (draw_spec_shift).
            view: precompute_view's result for this camera, or None.
            spec_shift: [B, num_uniforms] uniforms that replace the draw.
        Returns:
            dict of [6, res, res, C] tensors: rgb, albedo, normal, position,
            empty_mask, roughness_womipmap, roughness.
        """
        cam = torch.as_tensor(cam_position, dtype=torch.float32,
                              device=self.device)
        if view is None:
            view = self.precompute_view(params, mvp, cam)
        normal = view["normal"]
        position = view["position"]
        f, h, w, _ = normal.shape
        b = f * h * w
        # this rank's pixels: all of them, or its share under spmd_mesh,
        # drawn with their global ids
        shares, row = ([slice(0, b)], None) if self.spmd_mesh is None \
            else self.pixel_shares(b)
        mine = shares[self.spmd_mesh.rank if self.spmd_mesh else 0]
        if spec_shift is None and self.spmd_mesh is not None:
            spec_shift = self.draw_spec_shift(
                seed, b, ids=torch.arange(mine.start, mine.stop,
                                          device=self.device))
        else:
            if spec_shift is None:
                spec_shift = self.draw_spec_shift(seed, b)
            spec_shift = torch.as_tensor(spec_shift, dtype=torch.float32,
                                         device=self.device)[mine]
        args = tuple(a[mine] for a in (
            view["uv"], view["lod_a"], view["lod_r"], view["lod_i"],
            normal.reshape(b, 3), position.reshape(b, 3))) + (spec_shift,)
        if self.atlas_mesh is not None:
            from texir_code_tpu_torch.parallel.atlas_tp import (
                tp_sample_materials,
            )

            uv, lod_a, lod_r, lod_i = args[:4]
            alb, rgh, womip = tp_sample_materials(
                self.atlas_mesh, params.albedo, params.roughness, uv, lod_a,
                lod_r, self.max_mip_level)
            irr = texture_sample(self.irt_pyramid, uv, lod_i)
            rgb, albedo, roughness, roughness_womip = self._stage_shade(
                alb, rgh, womip, irr, *args[4:], cam, stage)
            return self._outputs(stage, view, rgb, albedo, roughness,
                                 roughness_womip)
        alb_pyr = build_mip_pyramid(params.albedo, self.max_mip_level)
        rgh_pyr = build_mip_pyramid(params.roughness, self.max_mip_level)

        def shade(a):
            return self._shade_flat(alb_pyr, rgh_pyr, params.roughness, *a,
                                    cam, stage, row_width=row)

        if self.shade_chunk:
            # pixel chunks, as the reference's split_input; the pyramids
            # are built once for all of them
            outs = map_chunked(shade, args, int(self.shade_chunk))
        else:
            outs = shade(args)
        if self.spmd_mesh is not None:
            from texir_code_tpu_torch.parallel.mesh import all_gather_rows

            counts = [sl.stop - sl.start for sl in shares]
            outs = [all_gather_rows(o, self.spmd_mesh, counts) for o in outs]
        rgb, albedo, roughness, roughness_womip = outs
        return self._outputs(stage, view, rgb, albedo, roughness,
                             roughness_womip)

    @staticmethod
    def _outputs(stage, view, rgb, albedo, roughness, roughness_womip):
        normal = view["normal"]
        position = view["position"]
        f, h, w, _ = normal.shape
        if stage == 0:
            position_out = position + 1e-1 * normal
        else:
            # the reference offsets +1e-2·n at render input, +2e-2·n on output
            position_out = position + 3e-2 * normal
        return {
            "rgb": rgb.reshape(f, h, w, 3),
            "albedo": albedo.reshape(f, h, w, 3),
            "normal": normal,
            "position": position_out,
            "empty_mask": view["mask"],
            "roughness_womipmap": roughness_womip.reshape(f, h, w, 1),
            "roughness": roughness.reshape(f, h, w, 1),
        }

    # -- implementation ----------------------------------------------------

    def _shade_flat(self, alb_pyr, rgh_pyr, rough_base, uv, lod_a, lod_r,
                    lod_i, normal, position, spec_shift, cam_position,
                    stage: int, row_width: Optional[int] = None):
        """All differentiable per-pixel work on flat tensors: the four
        texture fetches (reference :128-139) from the albedo and roughness
        pyramids and the base roughness atlas, and the stage's shading.
        row_width: the specular walk's row width (default the model's)."""
        # column 2 is the stochastic-LOD uniform, columns 3-4 the
        # bilinear-corner uniforms (present only with their knobs)
        if spec_shift.shape[-1] > 4:
            rng = spec_shift[:, 2:5]
        elif spec_shift.shape[-1] > 2:
            rng = spec_shift[:, 2]
        else:
            rng = None
        albedo = texture_sample(alb_pyr, uv, lod_a, rng=rng)
        roughness = texture_sample(rgh_pyr, uv, lod_r, rng=rng)
        roughness_womip = bilinear_sample(rough_base, uv)
        irr = texture_sample(self.irt_pyramid, uv, lod_i, rng=rng)
        return self._stage_shade(albedo, roughness, roughness_womip, irr,
                                 normal, position, spec_shift, cam_position,
                                 stage, row_width)

    def _stage_shade(self, albedo, roughness, roughness_womip, irr, normal,
                     position, spec_shift, cam_position, stage: int,
                     row_width: Optional[int] = None):
        """The stage's shading of sampled materials (the reference forward
        after its dr.texture calls, models/mat_nvdiffrast.py:141-190)."""
        kw = dict(row_width=row_width)
        if stage == -1:
            rgb = self._render_flat(
                normal, torch.zeros_like(albedo),
                torch.full_like(roughness, 0.01), position + 1e-2 * normal,
                cam_position, irr, spec_shift, vhl=True, **kw,
            )
            albedo_out = torch.zeros_like(albedo)
        elif stage == 0:
            rgb = shading.lambertian_diffuse(irr, albedo)
            albedo_out = albedo
        elif stage == 1:
            albedo_out = albedo.detach()
            rgb = self._render_flat(
                normal, albedo_out, roughness_womip, position + 1e-2 * normal,
                cam_position, irr, spec_shift, **kw,
            )
        elif stage == 2:
            rgb = self._render_flat(
                normal, albedo, roughness, position + 1e-2 * normal,
                cam_position, irr, spec_shift, **kw,
            )
            albedo_out = albedo
        else:
            raise ValueError(f"unknown stage: {stage}")
        return rgb, albedo_out, roughness, roughness_womip

    def _render_flat(self, normal, albedo, roughness, points, cam_position,
                     irr, spec_shift, vhl: bool = False,
                     row_width: Optional[int] = None) -> torch.Tensor:
        """Physically based shading on flat per-pixel tensors (reference
        models/mat_nvdiffrast.py:201-249): diffuse from the IrT, specular
        by GGX-importance MC against the TBL (or its VHL emitter).
        Returns rgb [B, 3]."""
        from texir_code_tpu_torch.models.tbl import query_tbl_auto

        b = normal.shape[0]
        n = tuple(normal[:, k] for k in range(3))
        pts = tuple(points[:, k] for k in range(3))
        rgh = roughness.reshape(b)

        view = tuple(cam_position[k] - pts[k] for k in range(3))
        vnorm = torch.clamp_min(
            torch.sqrt(view[0] ** 2 + view[1] ** 2 + view[2] ** 2), 1e-4
        )
        view = tuple(v / vnorm for v in view)
        diffuse = shading.lambertian_diffuse(irr, albedo)

        s_spec = self.sample_light[1]
        samples = torch.clamp(
            torch.remainder(
                hammersley(s_spec, self.device)[None]
                + spec_shift[:, None, :2], 1.0
            ),
            TINY_NUMBER, 1.0 - TINY_NUMBER,
        )
        half = generate_dir_soa(n, s_spec, mode=self.sample_type[1],
                                roughness=rgh, samples=samples)
        light_dirs, _ = reflect_soa(view, half)
        spec_origins = tuple(p[:, None].expand(b, s_spec) for p in pts)
        tbl = self.tbl_vhl if vhl else self.tbl
        rgbe_pre = None
        if self.specular_fetch == "prefiltered":
            rgbe_pre = self._rgbe_pre_vhl if vhl else self._rgbe_pre
        lighting = query_tbl_auto(
            tbl, spec_origins, tuple(d.detach() for d in light_dirs),
            self.cluster_scene, rgbe_pre=rgbe_pre,
            fan_block=self.spec_fan_block, exit_rows=self.spec_exit_rows,
            row_width=row_width or self.spec_row_width,
            two_pass_cut=self.spec_two_pass_cut,
            two_pass_cap=self.spec_two_pass_cap, proxy=self.proxy_scene,
            occluders=self.occluders, fan_scene=self.fan_scene,
        )
        spec = shading.specular_estimator_soa(
            lighting, half, n, view, light_dirs, rgh
        )
        return diffuse + torch.stack(spec, dim=-1) / s_spec
