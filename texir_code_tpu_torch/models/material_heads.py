"""The baseline material heads: InvRender, NeILF and nvdiffrec.

The port of the JAX package's `models/material_heads.py` (reference
models/mat_nvdiffrast_{invrender,neilf,recMLP}.py): three SVBRDF
parameterisations by a neural field, rendered by the same G-buffer + IrT +
TBL machinery as the flagship MaterialModel, on one device.

  * InvRender: material from the latent-32 BRDF autoencoder
    (`fields.EnvmapMaterialNetwork`), with the latent pair for the KL and
    smoothness loss.
  * NeILF: material from the SIREN `fields.BRDFMLP`; the spatial gradient
    of roughness comes from `torch.autograd.grad` with a graph (the
    reference's own form; JAX takes three jvps: each point's roughness
    depends on that point alone, so it is the same gradient), and the loss
    differentiates through it.  Diffuse lighting is integrated from the
    trained `fields.NeILFMLP` incident-light field, specular from the TBL.
    Roughness is channel 3 (the reference slices channel 0, the albedo's
    red: mat_nvdiffrast_neilf.py:129-130; the JAX package uses channel 3).
  * nvdiffrec: material from the hash-grid `fields.MLPTexture3D`, with the
    smoothness of a resample at positions jittered by σ 0.01.

A step renders a camera's six cube faces.  The G-buffer (primary rays
through the culled walk, B1 `shared_prim`) and the IrT irradiance (the mip
sampler) depend only on the camera: `precompute_view` computes them once
and `_forward(view=)` takes them back.  Specular light is GGX importance
MC against the TBL; its rays go through `models.tbl.query_tbl_auto` (B1
`per_ray_prim` on the card, its plain version on the CPU), radiance from
the hit's primitive and barycentrics, as the JAX heads fetch it.

Random numbers: every draw is a counter hash of (seed, pixel id, stream)
(`draw`): the specular sample shift (streams 0-1), then NeILF's diffuse
sample shift, InvRender's latent noise or nvdiffrec's position jitter
(standard normals by Box-Muller).  Torch cannot reproduce JAX's threefry
keys; `_forward(draws=)` takes the JAX head's own draws in the parity
tests.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.models import fields
from texir_code_tpu_torch.ops import shading
from texir_code_tpu_torch.ops.gbuffer import DeviceMesh, render_gbuffer
from texir_code_tpu_torch.ops.sampling import (
    generate_dir_soa,
    hash_uniform,
    reflect_soa,
    shifted_samples,
)
from texir_code_tpu_torch.ops.texture import (
    build_mip_pyramid,
    compute_lod,
    texture_sample,
)


def _normals(u: torch.Tensor) -> torch.Tensor:
    """[B, 2k] uniforms in [0, 1) → [B, k] standard normals (Box-Muller)."""
    u1, u2 = u[:, 0::2], u[:, 1::2]
    return (torch.sqrt(-2.0 * torch.log1p(-u1))
            * torch.cos(2.0 * math.pi * u2))


class _HeadBase:
    """The heads' shared scene on one device: the BVH's TBL, the lb-8
    ClusterScene of the walk, the mesh's G-buffer attributes and the IrT's
    mip pyramid."""

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
        device="cuda",
    ):
        """Args mirror the reference config knobs: pano_res
        (train.pano_img_res; cube_res = pano_res[1] // 4), sample_light
        (diffuse spp, NeILF's only; specular spp), sample_type, the TBL's
        hdr_exposure, max_mip_level (default get_mip_level(8192) = 13).
        device: where every scene tensor lives (default: the card)."""
        from texir_code_tpu_torch.geometry.bvh import build_bvh
        from texir_code_tpu_torch.models.tbl import build_tbl_from_flat
        from texir_code_tpu_torch.ops.fan_raycast import FanScene
        from texir_code_tpu_torch.ops.pallas_culled import ClusterScene

        self.device = resolve_device(device)
        self.cube_res = int(pano_res[1] // 4)
        self.sample_light = tuple(sample_light)
        self.sample_type = tuple(sample_type)
        self.max_mip_level = (
            max_mip_level if max_mip_level is not None
            else shading.get_mip_level(8192)
        )
        self.mesh = mesh
        self.device_mesh = DeviceMesh.from_mesh(mesh, self.device)
        flat = build_bvh(mesh.vertices, mesh.faces)
        self.tbl = build_tbl_from_flat(flat, mesh, hdr_texture, hdr_exposure,
                                       device=self.device)
        self.fan_scene = FanScene.from_flat(flat)
        self.cluster_scene = ClusterScene.from_fan(
            self.fan_scene, lb=8, dense=True, device=self.device)
        self.irt = torch.as_tensor(np.asarray(irt_texture, np.float32),
                                   device=self.device)
        self.irt_pyramid = build_mip_pyramid(self.irt, self.max_mip_level)

    # -- random draws ------------------------------------------------------

    num_uniforms = 2  # the specular sample shift

    def _extra_draws(self, u: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def draw(self, seed: int, num_pixels: int) -> Dict[str, torch.Tensor]:
        """The step's per-pixel draws, a counter hash of (seed, pixel id,
        stream): "spec_shift" [B, 2] and the head's own."""
        u = hash_uniform(seed, torch.arange(num_pixels, device=self.device),
                         torch.arange(self.num_uniforms, device=self.device))
        return {"spec_shift": u[:, :2], **self._extra_draws(u[:, 2:])}

    # -- the scene ---------------------------------------------------------

    def precompute_view(self, mvp, cam_position):
        """The camera's step constants: (position, normal, irradiance
        [6, r, r, 3], mask [6, r, r, 1]) from the G-buffer and the IrT.  A
        trainer computes them once per view and passes them back through
        `_forward(view=)`."""
        mvp, cam = self._tensor(mvp), self._tensor(cam_position)
        with torch.no_grad():
            g = render_gbuffer(self.device_mesh, mvp, cam, self.cube_res,
                               self.cluster_scene)
            lod = compute_lod(g.uv, self.irt.shape[0], self.irt.shape[1])
            irr = texture_sample(self.irt_pyramid, g.uv.reshape(-1, 2),
                                 lod.reshape(-1))
        return g.position, g.normal, irr.reshape(g.position.shape), g.mask

    def _tensor(self, x) -> torch.Tensor:
        """x as a float32 tensor on the model's device (an array copied)."""
        if torch.is_tensor(x):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.array(x, np.float32), device=self.device)

    def _setup(self, mvp, cam_position, seed, view, draws):
        """Per-step inputs: the view's tensors, flat normals and offset
        points as SoA, unit view directions, and the draws."""
        cam = self._tensor(cam_position)
        if view is None:
            view = self.precompute_view(mvp, cam)
        position, normal, irr, mask = (self._tensor(x) for x in view)
        b = position.shape[0] * position.shape[1] * position.shape[2]
        if draws is None:
            draws = self.draw(seed, b)
        draws = {k: self._tensor(v).reshape(b, -1) for k, v in draws.items()}
        offset = position + 1e-2 * normal
        n = tuple(normal[..., k].reshape(b) for k in range(3))
        pts = tuple(offset[..., k].reshape(b) for k in range(3))
        vdir = tuple(cam[k] - pts[k] for k in range(3))
        vn = torch.clamp_min(torch.sqrt(vdir[0] * vdir[0] + vdir[1] * vdir[1]
                                        + vdir[2] * vdir[2]), 1e-4)
        vdir = tuple(v / vn for v in vdir)
        return position, normal, irr, mask, n, pts, vdir, draws

    def _specular(self, n, vdir, pts, rgh, spec_shift) -> torch.Tensor:
        """[B, 3] GGX importance MC against the TBL, its rays traced from
        the offset points."""
        from texir_code_tpu_torch.models.tbl import query_tbl_auto

        s = self.sample_light[1]
        half = generate_dir_soa(n, s, mode=self.sample_type[1], roughness=rgh,
                                samples=shifted_samples(s, spec_shift))
        light_dirs, _ = reflect_soa(vdir, half)
        b = n[0].shape[0]
        lighting = query_tbl_auto(
            self.tbl, tuple(p[:, None].expand(b, s) for p in pts),
            tuple(d.detach() for d in light_dirs), self.cluster_scene)
        spec = shading.specular_estimator_soa(lighting, half, n, vdir,
                                              light_dirs, rgh)
        return torch.stack(spec, dim=-1) / s

    def forward(self, params, mvp, cam_position,
                seed: int = 0) -> Dict[str, torch.Tensor]:
        """Render one camera from scratch (G-buffer included)."""
        return self._forward(params, mvp, cam_position, seed=seed)


class InvRenderMaterialModel(_HeadBase):
    """InvRender head (reference models/mat_nvdiffrast_invrender.py)."""

    num_uniforms = 2 + 64  # and 32 latent normals

    def __init__(self, *args, network_kw: Optional[Dict] = None, **kw):
        super().__init__(*args, **kw)
        self.network_kw = dict(network_kw or {})

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> nn.Module:
        return fields.EnvmapMaterialNetwork(
            **self.network_kw, generator=generator).to(self.device)

    def _extra_draws(self, u):
        return {"latent_noise": _normals(u)}

    def query_materials(self, params, points):
        """(albedo [N, 3], roughness [N, 1]) at world points."""
        out = params(points)
        return out["diffuse_albedo"], out["roughness"]

    def _forward(self, params, mvp, cam_position, seed: int = 0, view=None,
                 draws=None) -> Dict[str, torch.Tensor]:
        position, normal, irr, mask, n, pts, vdir, draws = self._setup(
            mvp, cam_position, seed, view, draws)
        f, h, w, _ = normal.shape
        b = f * h * w
        mats = params(position.reshape(b, 3), noise=draws["latent_noise"])
        albedo, roughness = mats["diffuse_albedo"], mats["roughness"]
        diffuse = shading.lambertian_diffuse(irr.reshape(b, 3), albedo)
        specular = self._specular(n, vdir, pts, roughness[:, 0],
                                  draws["spec_shift"])
        return {
            "rgb": (diffuse + specular).reshape(f, h, w, 3),
            "albedo": albedo.reshape(f, h, w, 3),
            "roughness": roughness.reshape(f, h, w, 1),
            "normal": normal,
            "position": position + 1e-2 * normal,
            "empty_mask": mask,
            "latent_pre_sigmoid": mats["latent_pre_sigmoid"],
            "diffuse_albedo": albedo.reshape(f, h, w, 3),
            "random_xi_diffuse_albedo":
                mats["random_xi_diffuse_albedo"].reshape(f, h, w, 3),
            "random_xi_roughness":
                mats["random_xi_roughness"].reshape(f, h, w, 1),
        }


class NeILFMaterialModel(_HeadBase):
    """NeILF head (reference models/mat_nvdiffrast_neilf.py).  Its
    parameters are an `nn.ModuleDict` {"brdf": BRDFMLP, "light":
    NeILFMLP}."""

    num_uniforms = 4  # and the diffuse sample shift

    def __init__(self, *args, brdf_kw: Optional[Dict] = None,
                 light_kw: Optional[Dict] = None, **kw):
        super().__init__(*args, **kw)
        self.brdf_kw = dict(brdf_kw or {})
        self.light_kw = dict(light_kw or {})

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> nn.ModuleDict:
        return nn.ModuleDict({
            "brdf": fields.BRDFMLP(**self.brdf_kw, generator=generator),
            "light": fields.NeILFMLP(**self.light_kw, generator=generator),
        }).to(self.device)

    def _extra_draws(self, u):
        return {"diff_shift": u[:, :2]}

    def query_materials(self, params, points):
        m = params["brdf"](points)
        return m[..., 0:3], m[..., 3:4]

    def _forward(self, params, mvp, cam_position, seed: int = 0, view=None,
                 draws=None) -> Dict[str, torch.Tensor]:
        position, normal, irr, mask, n, pts, vdir, draws = self._setup(
            mvp, cam_position, seed, view, draws)
        f, h, w, _ = normal.shape
        b = f * h * w
        # roughness and its spatial gradient from one forward; with a graph
        # when the caller differentiates (the loss runs through it)
        train = torch.is_grad_enabled()
        with torch.enable_grad():
            p = position.reshape(b, 3).detach().requires_grad_(True)
            m = params["brdf"](p)
            (brdf_grad,) = torch.autograd.grad(m[:, 3].sum(), p,
                                               create_graph=train)
        if not train:
            m = m.detach()
        albedo, roughness = m[:, 0:3], m[:, 3:4]

        # diffuse from the incident-light field (reference :182-187)
        s_diff = self.sample_light[0]
        ld = generate_dir_soa(n, s_diff, mode=self.sample_type[0],
                              samples=shifted_samples(s_diff,
                                                       draws["diff_shift"]))
        pts_rep = torch.stack([p_[:, None].expand(b, s_diff) for p_ in pts],
                              dim=-1)
        inp = torch.cat([pts_rep, torch.stack(ld, dim=-1)],
                        dim=-1).reshape(-1, 6)
        radiance = shading.hdr_recover(params["light"](inp)).reshape(
            b, s_diff, 3)
        ndl = torch.clamp(n[0][:, None] * ld[0] + n[1][:, None] * ld[1]
                          + n[2][:, None] * ld[2], 0.0, 1.0)[..., None]
        diffuse = (radiance * (albedo[:, None, :] / math.pi) * ndl * 2
                   * math.pi).sum(dim=1) / s_diff

        specular = self._specular(n, vdir, pts, roughness[:, 0],
                                  draws["spec_shift"])
        return {
            "rgb": (diffuse + specular).reshape(f, h, w, 3),
            "albedo": albedo.reshape(f, h, w, 3),
            "roughness": roughness.reshape(f, h, w, 1),
            "brdf_grad": brdf_grad.reshape(f, h, w, 3),
            "normal": normal,
            "position": position,
            "empty_mask": mask,
        }


class NvDiffRecMaterialModel(_HeadBase):
    """nvdiffrec head (reference models/mat_nvdiffrast_recMLP.py)."""

    num_uniforms = 2 + 6  # and 3 jitter normals

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.aabb = self.mesh.aabb()

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> nn.Module:
        return fields.MLPTexture3D(self.aabb, channels=4,
                                   generator=generator).to(self.device)

    def _extra_draws(self, u):
        return {"jitter": _normals(u)}

    def query_materials(self, params, points):
        m = params(points)
        return m[..., 0:3], m[..., 3:4]

    def _forward(self, params, mvp, cam_position, seed: int = 0, view=None,
                 draws=None) -> Dict[str, torch.Tensor]:
        position, normal, irr, mask, n, pts, vdir, draws = self._setup(
            mvp, cam_position, seed, view, draws)
        f, h, w, _ = normal.shape
        b = f * h * w
        pts_img = position.reshape(b, 3)
        mats = params(pts_img)
        albedo, roughness = mats[:, 0:3], mats[:, 3:4]
        # the jittered resample's smoothness (reference :136-138, σ 0.01)
        mats_jit = params(pts_img + draws["jitter"] * 0.01)
        kd_grad = (mats_jit[:, 0:3] - albedo).abs().sum(
            dim=-1, keepdim=True) / 3.0
        diffuse = shading.lambertian_diffuse(irr.reshape(b, 3), albedo)
        specular = self._specular(n, vdir, pts, roughness[:, 0],
                                  draws["spec_shift"])
        return {
            "rgb": (diffuse + specular).reshape(f, h, w, 3),
            "albedo": albedo.reshape(f, h, w, 3),
            "roughness": roughness.reshape(f, h, w, 1),
            "kd_grad": kd_grad.reshape(f, h, w, 1),
            "normal": normal,
            "position": position + 1e-2 * normal,
            "empty_mask": mask,
        }


HEADS = {"invrender": InvRenderMaterialModel, "neilf": NeILFMaterialModel,
         "recmlp": NvDiffRecMaterialModel}
