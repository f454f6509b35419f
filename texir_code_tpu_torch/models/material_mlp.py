"""MLP material model over panorama G-buffers.

The port of the JAX package's `models/material_mlp.py` (reference
models/mat_mlp.py:30-228, `MaterialMLP`): the pre-nvdiffrast pipeline kept
as an alternative.  Albedo and roughness come from a `fields.MatNetwork`
(4×512, 4 outputs) at the G-buffer positions of an equirectangular camera;
the G-buffer is the pano rays cast against the BVH
(`ops.raycast.cast_rays_soa`, t_min 1e-5), and shading is TBL diffuse
(uniform hemisphere) + GGX importance specular Monte Carlo, both queried
through the BVH (`models.tbl.query_tbl_soa`), as the JAX model does.

Random numbers: the diffuse and specular sample shifts are a counter hash
of (seed, pixel id, stream) (`draw`); `forward(draws=)` takes the JAX
model's own (its threefry draws) in the parity tests.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.models.fields import MatNetwork
from texir_code_tpu_torch.models.tbl import build_tbl, query_tbl_soa
from texir_code_tpu_torch.ops import shading
from texir_code_tpu_torch.ops.gbuffer import DeviceMesh, interpolate_attributes
from texir_code_tpu_torch.ops.raycast import cast_rays_soa
from texir_code_tpu_torch.ops.sampling import (
    generate_dir_soa,
    hash_uniform,
    reflect_soa,
    shifted_samples,
)


def pano_dirs(pano_res: Tuple[int, int]) -> np.ndarray:
    """[H·W, 3] float32 camera-frame directions of an equirectangular pano
    (θ from -π to π across, φ from π/2 down to -π/2), formed in numpy as
    the JAX models form them: linspace in float64, rounded once."""
    h, w = pano_res
    theta, phi = np.meshgrid(
        np.linspace(-np.pi, np.pi, w, dtype=np.float32),
        np.linspace(0.5 * np.pi, -0.5 * np.pi, h, dtype=np.float32),
    )
    return np.stack(
        [np.cos(phi) * np.sin(theta), np.sin(phi),
         np.cos(phi) * np.cos(theta)], axis=-1).reshape(-1, 3)


def draw_shifts(seed: int, num_pixels: int, device) -> Dict[str, torch.Tensor]:
    """A step's per-pixel draws, a counter hash of (seed, pixel id,
    stream): the diffuse and specular sample shifts "diff_shift" and
    "spec_shift", [B, 2] each."""
    u = hash_uniform(seed, torch.arange(num_pixels, device=device),
                     torch.arange(4, device=device))
    return {"diff_shift": u[:, :2], "spec_shift": u[:, 2:]}


class MaterialMLP:
    """MLP SVBRDF over pano G-buffers."""

    def __init__(
        self,
        mesh,
        hdr_texture: np.ndarray,
        pano_res: Tuple[int, int] = (128, 256),
        sample_light: Tuple[int, int] = (32, 16),
        hdr_exposure: float = 0.0,
        network_kw: Optional[Dict] = None,
        device="cuda",
    ):
        """network_kw: `fields.MatNetwork` arguments over the default
        4×512 network with 4 outputs.  device: where every scene tensor
        lives (default: the card)."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.pano_res = tuple(pano_res)
        self.sample_light = tuple(sample_light)
        self.tbl = build_tbl(mesh, hdr_texture, hdr_exposure,
                             device=self.device)
        self.device_mesh = DeviceMesh.from_mesh(mesh, self.device)
        self.network_kw = {"dims": (512,) * 4, "p_out_dim": 4,
                           **(network_kw or {})}
        d = torch.from_numpy(pano_dirs(self.pano_res)).to(self.device)
        self._pano_dirs = tuple(d[:, k].contiguous() for k in range(3))

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> nn.Module:
        return MatNetwork(**self.network_kw,
                          generator=generator).to(self.device)

    def draw(self, seed: int, num_pixels: int) -> Dict[str, torch.Tensor]:
        return draw_shifts(seed, num_pixels, self.device)

    def forward(self, params: nn.Module, cam_position, seed: int = 0,
                draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """Render the pano at `cam_position` with the network `params`:
        rgb, albedo [H, W, 3], roughness, empty_mask [H, W, 1]."""
        h, w = self.pano_res
        b = h * w
        cam = torch.as_tensor(np.asarray(cam_position, np.float32),
                              device=self.device)
        if draws is None:
            draws = self.draw(seed, b)
        draws = {k: torch.as_tensor(v, dtype=torch.float32,
                                    device=self.device).reshape(b, 2)
                 for k, v in draws.items()}
        o = tuple(torch.zeros(b, device=self.device) + cam[k]
                  for k in range(3))
        with torch.no_grad():
            hit = cast_rays_soa(self.tbl.bvh, o, self._pano_dirs, t_min=1e-5)
            pos, nrm, _ = interpolate_attributes(self.device_mesh, hit)
        valid = (hit.prim >= 0)[:, None]
        pos = torch.where(valid, pos, 0.0)
        nrm = torch.where(valid, nrm, torch.tensor([0.0, 0.0, 1.0],
                                                   device=self.device))

        mats = params(pos)
        albedo = torch.sigmoid(mats[..., 0:3])
        roughness = torch.sigmoid(mats[..., 3:4]) * 0.9 + 0.09

        n = tuple(nrm[:, k] for k in range(3))
        pts = tuple((pos + 1e-2 * nrm)[:, k] for k in range(3))
        view = tuple(cam[k] - pts[k] for k in range(3))
        vn = torch.clamp_min(torch.sqrt(view[0] * view[0] + view[1] * view[1]
                                        + view[2] * view[2]), 1e-4)
        view = tuple(v / vn for v in view)

        s_diff = self.sample_light[0]
        ld = generate_dir_soa(n, s_diff, mode="uniform",
                              samples=shifted_samples(s_diff,
                                                      draws["diff_shift"]))
        lighting = query_tbl_soa(
            self.tbl, tuple(p[:, None].expand(b, s_diff) for p in pts), ld)
        ndl = (n[0][:, None] * ld[0] + n[1][:, None] * ld[1]
               + n[2][:, None] * ld[2]).clamp(0.0, 1.0)
        diffuse = (torch.stack([(lighting[k] * ndl).sum(dim=1)
                                for k in range(3)], dim=-1)
                   * 2 * np.pi / s_diff) * albedo / np.pi

        s_spec = self.sample_light[1]
        half = generate_dir_soa(n, s_spec, mode="importance",
                                roughness=roughness[:, 0],
                                samples=shifted_samples(s_spec,
                                                        draws["spec_shift"]))
        light_dirs, _ = reflect_soa(view, half)
        spec_light = query_tbl_soa(
            self.tbl, tuple(p[:, None].expand(b, s_spec) for p in pts),
            tuple(d.detach() for d in light_dirs))
        spec = shading.specular_estimator_soa(spec_light, half, n, view,
                                              light_dirs, roughness[:, 0])
        specular = torch.stack(spec, dim=-1) / s_spec

        return {
            "rgb": (diffuse + specular).reshape(h, w, 3),
            "albedo": albedo.reshape(h, w, 3),
            "roughness": roughness.reshape(h, w, 1),
            "empty_mask": valid.to(torch.float32).reshape(h, w, 1),
        }
