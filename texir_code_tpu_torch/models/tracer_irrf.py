"""NIrF — the neural irradiance field's training model (stage IRRF).

The port of the JAX package's `models/tracer_irrf.py` (reference
models/tracer_o3d_irrf.py:29-255): per step, surface points get
Hammersley-stratified hemisphere directions, the ground-truth irradiance is
traced against the TBL on the device, and a `MatNetwork` MLP predicts
log-domain irradiance at the point and at a jittered point (the smoothness
pair, :125-128).  `forward` returns the reference's {gt, pred, pred_jit},
which `models.losses.IRFLoss` reads.

The trace goes through `models.tbl.query_tbl_auto`: with a ClusterScene
(the runner's, lb 8, dense) the rows of a point's rays share its origin and
the culled walk traces them — kernel B1 `per_ray_prim` in CUDA on the
card, its plain version on the CPU (the trace passes no prefiltered atlas,
so the walk emits prim + barycentrics and the radiance fetch is exact);
with `cluster_scene=None` the TBL's BVH does.

Random numbers.  A step's draws are keyed by (seed, global point id): the
per-row toroidal shift of the Hammersley set and the jitter's normals come
from the counter hash `ops.sampling.hash_uniform`, so they do not depend on
batching.  Parity tests replace `draw_samples` / `draw_jitter` with the JAX
package's own draws.

With `spmd_mesh` (parallel.mesh.DeviceMesh) each rank traces its share of
a batch's rows (whole exit groups of the walk, with their global row ids)
and the rows are gathered, so every rank holds the GT that one rank would
trace; a batch the ranks do not divide is traced whole on every rank, as
the JAX package does.  The networks stay replicated: every rank steps on
the same gathered GT.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from texir_code_tpu_torch.models.fields import MatNetwork
from texir_code_tpu_torch.ops.sampling import (
    TINY_NUMBER,
    generate_dir,
    hammersley,
    hash_uniform,
)
from texir_code_tpu_torch.ops.shading import hdr_recover, irradiance_estimator


def hammersley_shifted(seed: int, row_ids: torch.Tensor, s: int,
                       stream: int = 0) -> torch.Tensor:
    """[B, S, 2] Hammersley samples with one toroidal shift per row, the
    shift drawn from (seed, row id, streams `stream`, `stream` + 1) and
    clamped to [TINY, 1-TINY] (ops.sampling.stratified_samples)."""
    dev = row_ids.device
    shift = hash_uniform(seed, row_ids,
                         torch.arange(stream, stream + 2, device=dev))
    samples = torch.remainder(hammersley(s, dev)[None] + shift[:, None], 1.0)
    return samples.clamp(TINY_NUMBER, 1.0 - TINY_NUMBER)


def hash_normal(seed: int, row_ids: torch.Tensor, n: int,
                stream: int) -> torch.Tensor:
    """[B, n] standard normals keyed by (seed, row id), by Box-Muller on
    the counter hash's streams `stream` … `stream` + 2n - 1."""
    u = hash_uniform(seed, row_ids, torch.arange(
        stream, stream + 2 * n, device=row_ids.device)).reshape(-1, n, 2)
    radius = torch.sqrt(-2.0 * torch.log1p(-u[..., 0]))
    return radius * torch.cos(2.0 * math.pi * u[..., 1])


class TracerIRRF:
    """NIrF trainer model: MC irradiance ground truth + MLP prediction."""

    # counter-hash streams of a row: 0-1 the direction shift, 2+ the jitter
    JITTER_STREAM = 2

    def __init__(self, tbl, network: Optional[MatNetwork] = None,
                 std_jit: float = 5e-2, cluster_scene=None, spmd_mesh=None):
        """Args:
            tbl: the texture-based-lighting scene (emitter mesh + atlas).
            network: the irradiance MLP (default: the reference's
                irrf_network, PE(10) → 4×512 → 3).
            std_jit: the smoothness pair's jitter (train.std_jit).
            cluster_scene: ops.pallas_culled.ClusterScene of the mesh; the
                GT trace walks it (None: the TBL's BVH).
            spmd_mesh: optional parallel.mesh.DeviceMesh that splits the GT
                trace's rows over its ranks.
        """
        self.tbl = tbl
        self.network = network or MatNetwork()
        self.std_jit = std_jit
        self.cluster_scene = cluster_scene
        self.spmd_mesh = spmd_mesh

    def draw_samples(self, seed: int, row_ids: torch.Tensor,
                     s: int) -> torch.Tensor:
        """[B, S, 2] direction samples of rows `row_ids` for draw `seed`."""
        return hammersley_shifted(seed, row_ids, s)

    def draw_jitter(self, seed: int, row_ids: torch.Tensor) -> torch.Tensor:
        """[B, 3] unit normals of the smoothness pair's jitter."""
        return hash_normal(seed, row_ids, 3, self.JITTER_STREAM)

    def trace_rays(self, points: torch.Tensor, dirs: torch.Tensor,
                   row_width: int = 2048):
        """Radiance [B, S, 3] along dirs [B, S, 3] from points [B, 3]."""
        from texir_code_tpu_torch.models.tbl import query_tbl_auto

        b, s = dirs.shape[:2]
        pts = tuple(points[:, None, k].expand(b, s).contiguous()
                    for k in range(3))
        dd = tuple(dirs[..., k].contiguous() for k in range(3))
        return torch.stack(query_tbl_auto(self.tbl, pts, dd,
                                          self.cluster_scene,
                                          row_width=row_width), dim=-1)

    def _on_ranks(self, fn: Callable, b: int, s: int, *rows):
        """fn(*rows, row_width=...) over a batch of b rows of s rays each:
        whole, or under spmd_mesh (b divisible by the ranks) on this
        rank's share of the rows (tensors among `rows` are sliced, None
        passes) with every rank's outputs gathered."""
        from texir_code_tpu_torch.models.tbl import stream_group_rays

        mesh = self.spmd_mesh
        if mesh is None or b % mesh.size:
            return fn(*rows, row_width=2048)
        group, row = stream_group_rays(b * s)
        shares = mesh.shares(b, math.lcm(group, s) // s)
        mine = shares[mesh.rank]
        out = fn(*(a if a is None else a[mine] for a in rows), row_width=row)
        counts = [sl.stop - sl.start for sl in shares]
        if isinstance(out, tuple):
            return tuple(mesh.all_gather_rows(o.contiguous(), counts)
                         for o in out)
        return mesh.all_gather_rows(out, counts)

    @torch.no_grad()
    def trace_gt(self, points: torch.Tensor, normals: torch.Tensor,
                 resolution: Tuple[int, int], seed: int = 0,
                 row_ids: Optional[torch.Tensor] = None,
                 dirs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """MC ground-truth irradiance [B, 3]: Σ L·(n·l)·2π/S over
        S = h·w uniform hemisphere directions (reference :121-122).

        Args:
            points / normals: [B, 3].
            resolution: (h, w) direction grid (the env_res config).
            seed / row_ids: the draw (row ids default to 0..B-1).
            dirs: optional [B, S, 3] directions, replacing the draw.
        """
        s = resolution[0] * resolution[1]
        if row_ids is None:
            row_ids = torch.arange(points.shape[0], device=points.device)

        def rows(p, n, ids, d, row_width):
            if d is None:
                d = generate_dir(n, s, mode="uniform",
                                 samples=self.draw_samples(seed, ids, s))
            return irradiance_estimator(self.trace_rays(p, d, row_width), d,
                                        n, s)

        return self._on_ranks(rows, points.shape[0], s, points, normals,
                              row_ids, dirs)

    def forward(self, points: torch.Tensor, normals: torch.Tensor,
                resolution: Tuple[int, int], seed: int = 0,
                row_ids: Optional[torch.Tensor] = None,
                trace: bool = True) -> Dict[str, torch.Tensor]:
        """One training-step forward (reference :72-145): {gt, pred,
        pred_jit}; `pred` is in hdr_scale (log) domain."""
        if row_ids is None:
            row_ids = torch.arange(points.shape[0], device=points.device)
        out: Dict[str, torch.Tensor] = {}
        if trace:
            out["gt"] = self.trace_gt(points, normals, resolution, seed,
                                      row_ids)
        out["pred"] = self.network(points)
        jitter = self.draw_jitter(seed, row_ids) * self.std_jit
        out["pred_jit"] = self.network(points + jitter)
        return out

    @torch.no_grad()
    def predict_irradiance(self, points: torch.Tensor,
                           chunk: int = 65536) -> torch.Tensor:
        """Linear-domain irradiance at points [N, 3] (hdr_recover of the
        log-domain MLP output, reference models/mat_nvdiffrast.py:157),
        `chunk` points at a time."""
        return torch.cat([hdr_recover(self.network(p))
                          for p in points.split(chunk)])
