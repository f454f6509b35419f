"""IRF — the view-dependent incident-radiance field (stage IRF).

The port of the JAX package's `models/tracer_irf.py` (reference
models/tracer_o3d.py:29-219): per surface point, a Hammersley hemisphere
grid of directions; the ground truth is the TBL radiance along each
direction (not integrated, unlike NIrF); the prediction is an `IRNetwork`
evaluated per (point, direction).  The trace and its draws are those of
`tracer_irrf.TracerIRRF`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from texir_code_tpu_torch.models.fields import IRNetwork
from texir_code_tpu_torch.models.tracer_irrf import TracerIRRF
from texir_code_tpu_torch.ops.sampling import generate_dir


class TracerIRF(TracerIRRF):
    """View-dependent radiance tracer: {gt [B, S, 3], pred [B, S, 3]}."""

    def __init__(self, tbl, network: Optional[IRNetwork] = None,
                 cluster_scene=None, spmd_mesh=None):
        super().__init__(tbl, network or IRNetwork(dims=(512,) * 8),
                         cluster_scene=cluster_scene, spmd_mesh=spmd_mesh)

    @torch.no_grad()
    def trace_gt(self, points: torch.Tensor, normals: torch.Tensor,
                 resolution: Tuple[int, int], seed: int = 0,
                 row_ids: Optional[torch.Tensor] = None):
        """(dirs [B, S, 3], per-direction radiance [B, S, 3])."""
        s = resolution[0] * resolution[1]
        if row_ids is None:
            row_ids = torch.arange(points.shape[0], device=points.device)

        def rows(p, n, ids, row_width):
            dirs = generate_dir(n, s, mode="uniform",
                                samples=self.draw_samples(seed, ids, s))
            return dirs, self.trace_rays(p, dirs, row_width)

        return self._on_ranks(rows, points.shape[0], s, points, normals,
                              row_ids)

    def forward(self, points: torch.Tensor, normals: torch.Tensor,
                resolution: Tuple[int, int], seed: int = 0,
                row_ids: Optional[torch.Tensor] = None,
                trace: bool = True) -> Dict[str, torch.Tensor]:
        b = points.shape[0]
        s = resolution[0] * resolution[1]
        dirs, gt = self.trace_gt(points, normals, resolution, seed, row_ids)
        pts_rep = points[:, None, :].expand(b, s, 3).reshape(-1, 3)
        pred = self.network(pts_rep, dirs.reshape(-1, 3)).reshape(b, s, 3)
        out = {"pred": pred}
        if trace:
            out["gt"] = gt
        return out
