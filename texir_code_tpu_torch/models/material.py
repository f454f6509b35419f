"""MaterialModel — the TexIR SVBRDF texture optimizer (the flagship model).

The port of the JAX package's `models/material.py` (reference
models/mat_nvdiffrast.py:35-320) on one device.  One forward pass renders
a camera's six cube faces:

    G-buffer (primary rays through the culled walk)  [was dr.rasterize]
    mip-sampled albedo / roughness / IrT fetches      [was dr.texture ×4]
    diffuse  = IrT · albedo / π
    specular = GGX importance MC against the TBL, its rays traced by the
               culled walk with per-ray origins      [was query_irf]

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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.ops import shading
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

# knobs whose code paths are not ported yet → their ROADMAP.md item
_NOT_PORTED = {
    "spec_two_pass_cut": "queue A item 11 (two-pass trace)",
    "proxy_k": "queue A item 11 (occlusion proxy)",
    "shade_chunk": "queue A item 10 (pixel-chunked shading for eval)",
}


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
        spmd_mesh / atlas_mesh: multi-device paths, not ported.
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

        if spmd_mesh is not None or atlas_mesh is not None:
            raise NotImplementedError(
                "spmd_mesh/atlas_mesh: the multi-device Mat step is not "
                "ported yet (ROADMAP.md queue A item 16)"
            )
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
        fan = FanScene.from_flat(flat, triangle_uvs=mesh.triangle_uvs())
        cluster_lb = (render_knobs or {}).get("cluster_lb", cluster_lb)
        self.cluster_scene = ClusterScene.from_fan(
            fan, lb=cluster_lb, dense=True, device=self.device
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
        self.shade_chunk = None
        for k, v in (render_knobs or {}).items():
            if k == "cluster_lb":
                continue
            if not hasattr(self, k):
                raise ValueError(f"unknown render knob: {k}")
            setattr(self, k, v)
        for k, item in _NOT_PORTED.items():
            if getattr(self, k):
                raise NotImplementedError(f"{k}: not ported yet (ROADMAP.md {item})")
        if self.bilinear_stochastic and not self.mip_stochastic:
            raise ValueError("bilinear_stochastic requires mip_stochastic=True")
        if self.specular_fetch not in ("prefiltered", "exact"):
            raise ValueError(f"unknown specular_fetch {self.specular_fetch!r}")

        self._rgbe_pre = rgbe_prefilter(self.tbl.planes, 2)
        self._rgbe_pre_vhl = rgbe_prefilter(self.tbl_vhl.planes, 2)
        self.irt = torch.as_tensor(np.asarray(irt_texture, np.float32),
                                   device=self.device)
        # the IrT atlas is constant during Mat training: its pyramid is
        # built once (albedo/roughness pyramids are built per step, they
        # are differentiable functions of the parameters)
        self.irt_pyramid = build_mip_pyramid(self.irt, None)
        self.occluders = None
        if self.use_occluders:
            from texir_code_tpu_torch.geometry.occluders import extract_occluders

            self.occluders = extract_occluders(mesh, device=self.device)

    # -- random draws ------------------------------------------------------

    @property
    def num_uniforms(self) -> int:
        """Uniforms per pixel: the two sample-shift components, then the
        stochastic-LOD uniform, then the two bilinear-corner uniforms."""
        if self.bilinear_stochastic:
            return 5
        return 3 if self.mip_stochastic else 2

    def draw_spec_shift(self, seed: int, num_pixels: int) -> torch.Tensor:
        """[B, num_uniforms] per-pixel uniforms, a counter hash of (seed,
        global pixel id, column)."""
        ids = torch.arange(num_pixels, device=self.device)
        cols = torch.arange(self.num_uniforms, device=self.device)
        return hash_uniform(seed, ids, cols)

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
                row_width=self.gbuf_row_width, occluders=self.occluders,
            )
            uv_img = g.uv
            f, h, w, _ = g.normal.shape
            b = f * h * w
            lod = {
                name: compute_lod(uv_img, t.shape[0], t.shape[1]).reshape(b)
                for name, t in (("lod_a", params.albedo),
                                ("lod_r", params.roughness),
                                ("lod_i", self.irt))
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
        if spec_shift is None:
            spec_shift = self.draw_spec_shift(seed, b)
        spec_shift = torch.as_tensor(spec_shift, dtype=torch.float32,
                                     device=self.device)
        rgb, albedo, roughness, roughness_womip = self._shade_flat(
            params, view["uv"], view["lod_a"], view["lod_r"], view["lod_i"],
            normal.reshape(b, 3), position.reshape(b, 3), spec_shift, cam,
            stage,
        )
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

    def _shade_flat(self, params, uv, lod_a, lod_r, lod_i, normal, position,
                    spec_shift, cam_position, stage: int):
        """All differentiable per-pixel work on flat tensors: the four
        texture fetches (reference :128-139) and the stage's shading."""
        alb_pyr = build_mip_pyramid(params.albedo, self.max_mip_level)
        rgh_pyr = build_mip_pyramid(params.roughness, self.max_mip_level)
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
        roughness_womip = bilinear_sample(params.roughness, uv)
        irr = texture_sample(self.irt_pyramid, uv, lod_i, rng=rng)

        if stage == -1:
            rgb = self._render_flat(
                normal, torch.zeros_like(albedo),
                torch.full_like(roughness, 0.01), position + 1e-2 * normal,
                cam_position, irr, spec_shift, vhl=True,
            )
            albedo_out = torch.zeros_like(albedo)
        elif stage == 0:
            rgb = shading.lambertian_diffuse(irr, albedo)
            albedo_out = albedo
        elif stage == 1:
            albedo_out = albedo.detach()
            rgb = self._render_flat(
                normal, albedo_out, roughness_womip, position + 1e-2 * normal,
                cam_position, irr, spec_shift,
            )
        elif stage == 2:
            rgb = self._render_flat(
                normal, albedo, roughness, position + 1e-2 * normal,
                cam_position, irr, spec_shift,
            )
            albedo_out = albedo
        else:
            raise ValueError(f"unknown stage: {stage}")
        return rgb, albedo_out, roughness, roughness_womip

    def _render_flat(self, normal, albedo, roughness, points, cam_position,
                     irr, spec_shift, vhl: bool = False) -> torch.Tensor:
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
            row_width=self.spec_row_width, occluders=self.occluders,
        )
        spec = shading.specular_estimator_soa(
            lighting, half, n, view, light_dirs, rgh
        )
        return diffuse + torch.stack(spec, dim=-1) / s_spec
