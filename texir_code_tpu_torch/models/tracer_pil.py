"""PIL — the pre-integrated lighting field (stage PIL).

The port of the JAX package's `models/tracer_pil.py` (reference
models/tracer_o3d_pil.py:29-254): learn `PILNetwork(point, wo, roughness)
→ prefiltered specular radiance`.  Per training point: a uniform
roughness, one uniform outgoing direction wo, GGX-importance half vectors
reflected about wo, the TBL radiance along those rays, integrated with the
reference's estimator (:133-134).

Also `split_sum_lut`, the [res, res, 2] environment-BRDF (scale, bias)
table the reference ships as `models/bsdf_256_256.bin`.

Random numbers: a row's roughness, half-vector shift and wo samples come
from the counter hash keyed by (seed, global point id); parity tests
replace `draw` with the JAX package's draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from texir_code_tpu_torch.models.fields import PILNetwork
from texir_code_tpu_torch.models.tracer_irrf import (
    TracerIRRF,
    hammersley_shifted,
)
from texir_code_tpu_torch.ops.sampling import (
    TINY_NUMBER,
    generate_dir,
    hash_uniform,
    reflect,
)
from texir_code_tpu_torch.ops.shading import smith_g


class TracerPIL(TracerIRRF):
    # counter-hash streams of a row: 0 roughness, 1-2 the half-vector
    # shift, 3-4 wo
    def __init__(self, tbl, network: Optional[PILNetwork] = None,
                 cluster_scene=None, spmd_mesh=None):
        super().__init__(tbl, network or PILNetwork(dims=(128,) * 4),
                         cluster_scene=cluster_scene, spmd_mesh=spmd_mesh)

    def draw(self, seed: int, row_ids: torch.Tensor, s: int):
        """(roughness [B, 1], half-vector samples [B, S, 2], wo samples
        [B, 1, 2]) of rows `row_ids` for draw `seed`."""
        dev = row_ids.device
        rough = hash_uniform(seed, row_ids, torch.zeros(1, device=dev,
                                                        dtype=torch.int64))
        wo = hash_uniform(seed, row_ids, torch.arange(3, 5, device=dev))
        return (rough, hammersley_shifted(seed, row_ids, s, stream=1),
                wo.clamp(TINY_NUMBER, 1.0 - TINY_NUMBER)[:, None, :])

    @torch.no_grad()
    def trace_gt(self, points: torch.Tensor, normals: torch.Tensor,
                 num_samples: int, seed: int = 0,
                 roughness: Optional[torch.Tensor] = None,
                 row_ids: Optional[torch.Tensor] = None):
        """(roughness [B, 1], wo [B, 3], gt prefiltered radiance [B, 3]).

        roughness: optional fixed [B, 1] values (validation sweeps a fixed
        grid); None draws one uniform per point (reference :87)."""
        if row_ids is None:
            row_ids = torch.arange(points.shape[0], device=points.device)

        def rows(p, n, ids, rough, row_width):
            r_draw, half_s, wo_s = self.draw(seed, ids, num_samples)
            if rough is None:
                rough = r_draw
            half = generate_dir(n, num_samples, mode="importance",
                                roughness=rough, samples=half_s)
            wo = generate_dir(n, 1, mode="uniform", samples=wo_s)[:, 0, :]
            light_dirs, _ = reflect(wo, half)
            lighting = self.trace_rays(p, light_dirs, row_width)
            ndl = (n[:, None, :] * light_dirs).sum(
                dim=-1, keepdim=True).clamp(0.0, 1.0)
            gt = (lighting * ndl).sum(dim=1) * (2 * np.pi / num_samples)
            return rough, wo, gt

        return self._on_ranks(rows, points.shape[0], num_samples, points,
                              normals, row_ids, roughness)

    def forward(self, points: torch.Tensor, normals: torch.Tensor,
                resolution: Tuple[int, int], seed: int = 0,
                row_ids: Optional[torch.Tensor] = None,
                trace: bool = True) -> Dict[str, torch.Tensor]:
        s = resolution[0] * resolution[1]
        roughness, wo, gt = self.trace_gt(points, normals, s, seed,
                                          row_ids=row_ids)
        out = {"pred": self.network(points, wo, roughness),
               "roughness": roughness, "wo": wo}
        if trace:
            out["gt"] = gt
        return out


def split_sum_lut(res: int = 256, num_samples: int = 1024,
                  samples: Optional[torch.Tensor] = None,
                  device="cpu") -> np.ndarray:
    """[res, res, 2] environment-BRDF (scale, bias) table over (roughness
    row, n·v column): the split-sum pre-integration (Karis 2013) —
    GGX-importance integrate the Fresnel-weighted visibility, split into
    the scale/bias pair.  Every cell uses one draw of half-vector samples
    ([1, S, 2], default: one toroidal shift of the Hammersley set, as the
    JAX package uses one key for every cell)."""
    if samples is None:
        samples = hammersley_shifted(0, torch.zeros(1, dtype=torch.int64),
                                     num_samples)
    samples = torch.as_tensor(samples, dtype=torch.float32).to(device)
    ndv = torch.linspace(1e-3, 1.0, res, device=device)
    rough = torch.linspace(1e-3, 1.0, res, device=device)
    n = torch.tensor([[0.0, 0.0, 1.0]], device=device).expand(res, 3)
    v = torch.stack([torch.sqrt(1 - ndv ** 2), torch.zeros_like(ndv), ndv],
                    dim=-1)                                  # [res(ndv), 3]
    rows = []
    for r in rough:
        half = generate_dir(n, num_samples, mode="importance",
                            roughness=r.expand(res, 1),
                            samples=samples.expand(res, -1, -1))
        vdh = (half * v[:, None, :]).sum(-1, keepdim=True).clamp(0.0, 1.0)
        l = 2 * vdh * half - v[:, None, :]
        ndl = l[..., 2:3].clamp(0.0, 1.0)
        ndh = half[..., 2:3].clamp(0.0, 1.0)
        g = smith_g(ndv[:, None, None], ndl, r)
        g_vis = g * vdh / torch.clamp_min(ndh * ndv[:, None, None], 1e-7)
        fc = torch.pow(1.0 - vdh, 5.0)
        lit = (ndl > 0).to(g_vis.dtype)
        a = ((1 - fc) * g_vis * lit).sum(dim=(1, 2)) / num_samples
        b = (fc * g_vis * lit).sum(dim=(1, 2)) / num_samples
        rows.append(torch.stack([a, b], dim=-1))
    return torch.stack(rows).cpu().numpy()
