"""Evaluation renderer over optimized materials: editing and relighting.

The port of the JAX package's `eval/renderer.py` (reference
models/test_nvdiffrast.py:37-365):

  * `load_optimized_materials` loads the optimized albedo/roughness atlases
    from a Mat run's plots dir (the reference's `sort_res` picks the
    newest dump, :119-130);
  * `EvalMaterialModel` is the MaterialModel with pixel-chunked shading
    (`shade_chunk`, 4096 pixels by default), so the reference's eval spp
    (diffuse 1024 / specular 256, configs/test.conf:10) fits one device;
  * the per-texel seg atlas drives **editing**: chosen seg classes get a
    new albedo colour and/or roughness in texture space before sampling
    (`edited_params`, reference :166-241);
  * **relighting**: emitter texels above the light threshold take a new
    colour (`relit_tbl`, :105-110), and diffuse is shaded by live
    Monte-Carlo against the relit TBL instead of the baked IrT
    (`forward_relit`, :275-282); both traces fetch radiance exactly
    (prim + barycentrics), as the JAX renderer passes no prefiltered atlas.

Random numbers: the relit render's per-pixel sample shifts (two for the
diffuse set, two for the specular one) are a counter hash of (seed, pixel
id) — `draw_relit_shift` — where the JAX renderer folds the pixel id into
its key; tests inject JAX's draws there, as through `draw_spec_shift`.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.models.material import MaterialModel, MaterialParams
from texir_code_tpu_torch.models.tbl import TBL
from texir_code_tpu_torch.ops import shading
from texir_code_tpu_torch.ops.sampling import hash_uniform

# emitter texels: unexposed intensity at least this (reference :107-110)
EMITTER_THRESHOLD = 0.5


def load_optimized_materials(plots_dir: str, device="cuda") -> MaterialParams:
    """Newest atlas dump from a Mat run (reference sort_res, :119-130):
    the last `mat_albedo_*.hdr` / `mat_roughness_*.hdr` in name order,
    roughness from its first channel."""
    from texir_code_tpu_torch.data import hdrio

    def newest(pattern):
        files = sorted(glob.glob(os.path.join(plots_dir, pattern)))
        if not files:
            raise FileNotFoundError(f"no {pattern} in {plots_dir}")
        return files[-1]

    dev = resolve_device(device)
    albedo = hdrio.read_hdr(newest("mat_albedo_*.hdr"))
    rough = hdrio.read_hdr(newest("mat_roughness_*.hdr"))[..., 0:1]
    return MaterialParams(
        albedo=torch.from_numpy(np.ascontiguousarray(albedo)).to(dev),
        roughness=torch.from_numpy(np.ascontiguousarray(rough)).to(dev),
    )


class EvalMaterialModel(MaterialModel):
    """MaterialModel + pixel-chunked shading, seg-texture editing and
    relighting."""

    def __init__(self, *args, seg_texture: Optional[np.ndarray] = None,
                 shade_chunk: Optional[int] = 4096, **kw):
        super().__init__(*args, **kw)
        # [R, R] per-texel seg class (v-up), as float32 like the JAX model
        self.seg_texture = (
            torch.as_tensor(np.ascontiguousarray(seg_texture, np.float32),
                            device=self.device)
            if seg_texture is not None else None
        )
        # pixel chunking so the reference eval spp fits one device
        # (reference split_input, utils/general.py:28-58)
        self.shade_chunk = shade_chunk

    # -- editing ----------------------------------------------------------
    def edited_params(self, params: MaterialParams,
                      edits: Dict[int, Dict[str, object]]) -> MaterialParams:
        """Texture-space seg-class overrides (reference :166-241).

        edits: {seg_class: {"albedo": (r,g,b) and/or "roughness": x}}."""
        if self.seg_texture is None:
            raise ValueError("no seg texture loaded")
        albedo = params.albedo
        rough = params.roughness
        for cls, spec in edits.items():
            if "albedo" in spec:
                seg_a = self._seg_mask_for(albedo.shape[0])
                albedo = torch.where(
                    (seg_a == cls)[..., None],
                    torch.as_tensor(np.asarray(spec["albedo"], np.float32),
                                    device=albedo.device),
                    albedo)
            if "roughness" in spec:
                seg_r = self._seg_mask_for(rough.shape[0])
                rough = torch.where(
                    (seg_r == cls)[..., None],
                    torch.as_tensor(np.asarray(spec["roughness"], np.float32),
                                    device=rough.device),
                    rough)
        return MaterialParams(albedo=albedo, roughness=rough)

    def _seg_mask_for(self, res: int) -> torch.Tensor:
        """Nearest-resampled seg atlas at the target texture resolution."""
        seg = self.seg_texture
        h, w = seg.shape[:2]
        k = torch.arange(res, device=seg.device)
        return seg[k * h // res][:, k * w // res]

    # -- relighting -------------------------------------------------------
    def relit_tbl(self, new_color: Sequence[float]) -> TBL:
        """Emitter texels (unexposed intensity ≥ EMITTER_THRESHOLD) →
        new_color times their intensity: the emitter keeps its luminance
        and changes its chroma (reference :105-110)."""
        tex = torch.stack(self.tbl.planes, dim=-1)
        intensity = shading.rgb_to_intensity(tex * (2.0 ** -self.hdr_exposure))
        new = torch.as_tensor(np.asarray(new_color, np.float32),
                              device=tex.device) * intensity
        return self.tbl.with_texture(
            torch.where(intensity >= EMITTER_THRESHOLD, new, tex))

    def draw_relit_shift(self, seed: int, num_pixels: int) -> torch.Tensor:
        """[B, 4] per-pixel uniforms of the relit render: the diffuse set's
        toroidal shift (columns 0-1) and the specular set's (2-3)."""
        ids = torch.arange(num_pixels, device=self.device)
        return hash_uniform(seed, ids, torch.arange(4, device=self.device))

    def forward_relit(self, params: MaterialParams, mvp, cam_position,
                      seed: int = 0,
                      new_color: Sequence[float] = (1.0, 0.2, 0.2)
                      ) -> Dict[str, torch.Tensor]:
        """Relit render of one camera: diffuse by live MC over the relit
        TBL (reference :275-282; sample_light[0] rays a pixel), specular as
        usual against it, both in pixel chunks of `shade_chunk`.  Exact
        trilinear material fetches; the G-buffer as in training.

        Returns a dict of [6, res, res, C] tensors: rgb, albedo,
        roughness, normal, position, empty_mask."""
        from texir_code_tpu_torch.models.tbl import query_tbl_auto
        from texir_code_tpu_torch.ops.chunking import map_chunked
        from texir_code_tpu_torch.ops.sampling import (
            TINY_NUMBER,
            generate_dir_soa,
            hammersley,
            reflect_soa,
        )
        from texir_code_tpu_torch.ops.texture import (
            build_mip_pyramid,
            texture_sample,
        )

        tbl = self.relit_tbl(new_color)
        diffuse_spp = self.sample_light[0]
        cam = torch.as_tensor(cam_position, dtype=torch.float32,
                              device=self.device)
        view = self.precompute_view(params, mvp, cam)
        normal = view["normal"]
        position = view["position"]
        f, h, w, _ = normal.shape
        b = f * h * w
        albedo = texture_sample(
            build_mip_pyramid(params.albedo, self.max_mip_level),
            view["uv"], view["lod_a"])
        roughness = texture_sample(
            build_mip_pyramid(params.roughness, self.max_mip_level),
            view["uv"], view["lod_r"])
        normal_f = normal.reshape(b, 3)
        pts_f = (position + 1e-2 * normal).reshape(b, 3)
        shifts = torch.as_tensor(self.draw_relit_shift(seed, b),
                                 dtype=torch.float32, device=self.device)
        ham_d = hammersley(diffuse_spp, self.device)
        s_spec = self.sample_light[1]
        ham_s = hammersley(s_spec, self.device)
        trace = dict(occluders=self.occluders, fan_scene=self.fan_scene)

        def toroidal(ham, shift):
            return torch.clamp(torch.remainder(ham[None] + shift[:, None], 1.0),
                               TINY_NUMBER, 1.0 - TINY_NUMBER)

        def shade(a):
            nrm4, pts4, alb4, rgh4, shift4 = a
            bb = nrm4.shape[0]
            n = tuple(nrm4[:, k] for k in range(3))
            pts = tuple(pts4[:, k] for k in range(3))
            rgh = rgh4.reshape(bb)
            # live MC diffuse irradiance over the relit emitter
            dirs = generate_dir_soa(n, diffuse_spp, mode="uniform",
                                    samples=toroidal(ham_d, shift4[:, 0:2]))
            lighting = query_tbl_auto(
                tbl, tuple(p[:, None].expand(bb, diffuse_spp) for p in pts),
                dirs, self.cluster_scene, **trace)
            irr = torch.stack(shading.irradiance_estimator_soa(
                lighting, dirs, n, diffuse_spp), dim=-1)
            diffuse = shading.lambertian_diffuse(irr, alb4)

            v = tuple(cam[k] - pts[k] for k in range(3))
            vn = torch.clamp_min(torch.sqrt(sum(x * x for x in v)), 1e-4)
            v = tuple(x / vn for x in v)
            half = generate_dir_soa(n, s_spec, mode="importance",
                                    roughness=rgh,
                                    samples=toroidal(ham_s, shift4[:, 2:4]))
            light_dirs, _ = reflect_soa(v, half)
            spec_light = query_tbl_auto(
                tbl, tuple(p[:, None].expand(bb, s_spec) for p in pts),
                light_dirs, self.cluster_scene, **trace)
            spec = shading.specular_estimator_soa(spec_light, half, n, v,
                                                  light_dirs, rgh)
            return (diffuse + torch.stack(spec, dim=-1) / s_spec,)

        chunk = min(self.shade_chunk or b, b)
        (rgb,) = map_chunked(shade, (normal_f, pts_f, albedo, roughness,
                                     shifts), chunk)
        return {
            "rgb": rgb.reshape(f, h, w, 3),
            "albedo": albedo.reshape(f, h, w, 3),
            "roughness": roughness.reshape(f, h, w, 1),
            "normal": normal,
            "position": position,
            "empty_mask": view["mask"],
        }
