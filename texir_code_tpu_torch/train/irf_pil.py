"""IRF and PIL stage runners.

The port of the JAX package's `train/irf_pil.py` (reference
trainer/train_irf.py, the view-dependent radiance field, and
trainer/train_pil.py, the pre-integrated lighting field): the IRRF
runner's loop (`train.irrf.FieldRunner`: per-epoch point resampling, MC
ground truth against the TBL, Adam with the staircase decay over the MLP)
for `_PointFieldRunner.nepochs` epochs, then a checkpoint and the
stage's validation metric.  Both honour train.spmd, as the JAX runners do
(texir_code_tpu/train/irf_pil.py:64, :73): the GT traces split over the
ranks (train.irrf.FieldRunner).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.train.irrf import (
    FieldRunner,
    pano_metrics,
    step_seed,
)


class _PointFieldRunner(FieldRunner):
    """The loss of the IRF and PIL stages: the hdr_scale-domain L1 of the
    forward's pred against its gt."""

    def _loss(self, points, normals, seed, row_ids):
        from texir_code_tpu_torch.ops.shading import hdr_scale

        out = self.model.forward(points, normals, self.env_res, seed, row_ids)
        return (hdr_scale(out["gt"]) - out["pred"]).abs().mean()


class IRFTrainRunner(_PointFieldRunner):
    """View-dependent incident radiance field (reference
    trainer/train_irf.py)."""

    STAGE = "IRF"
    LOSS_TAG = "IRF_loss"

    def _build_model(self, tbl):
        from texir_code_tpu_torch.models.fields import IRNetwork
        from texir_code_tpu_torch.models.tracer_irf import TracerIRF

        c = "models.incident_radiance_network"
        if self.conf.get(c) is None:
            net = IRNetwork(generator=self.generator)
        else:
            net = IRNetwork(
                points_multires=self.conf.get_int(c + ".points_multires",
                                                  default=10),
                dirs_multires=self.conf.get_int(c + ".dirs_multires",
                                                default=4),
                dims=tuple(self.conf.get_list(c + ".dims",
                                              default=[512] * 8)),
                generator=self.generator,
            )
        return TracerIRF(tbl, net, cluster_scene=self.cluster_scene,
                         spmd_mesh=self.spmd_mesh)

    @torch.no_grad()
    def validate(self, epoch: int):
        """The direction-averaged radiance pano of the fixed val view, pred
        against the traced GT, with PSNR / SSIM (the reference validates
        this stage visually, trainer/train_irf.py:191-206; the metric is
        the JAX package's).  Batch j of 512 pixels draws with seed
        step_seed(40_000 + j)."""
        from texir_code_tpu_torch.data.datasets import ImageMeshPoint
        from texir_code_tpu_torch.ops.shading import hdr_recover

        t0 = time.time()
        h, w = val_res = tuple(self.conf.get_list("val.env_res",
                                                  default=[64, 128]))
        sample_res = tuple(self.conf.get_list("train.val_sample_res",
                                              default=[16, 32]))
        val = ImageMeshPoint(self.path_mesh, env_res=val_res,
                             device=self.device)
        pts, nrm = self._tensor(val.points), self._tensor(val.normals)
        ids = torch.arange(pts.shape[0], device=self.device)
        preds, gts = [], []
        for j, s in enumerate(range(0, pts.shape[0], 512)):
            sl = slice(s, s + 512)
            out = self.model.forward(pts[sl], nrm[sl], sample_res,
                                     step_seed(40_000 + j), ids[sl])
            # the mean over directions: GT linear radiance, pred log domain
            gts.append(out["gt"].mean(dim=1))
            preds.append(hdr_recover(out["pred"]).mean(dim=1))
        pred = torch.cat(preds).cpu().numpy().reshape(h, w, 3)
        gt = torch.cat(gts).cpu().numpy().reshape(h, w, 3)
        if self.exp.is_writer:
            hdrio.plot_irf(os.path.join(self.exp.plots_dir,
                                        f"irf_{epoch}.hdr"), pred, gt)
        self.val_metrics = pano_metrics(pred, gt, self.device)
        self.timings["val_s"] = time.time() - t0
        self._log_val(epoch)
        return self.val_metrics


class PILTrainRunner(_PointFieldRunner):
    """Pre-integrated lighting field (reference trainer/train_pil.py)."""

    STAGE = "PIL"
    LOSS_TAG = "PIL_loss"

    def _build_model(self, tbl):
        from texir_code_tpu_torch.models.fields import PILNetwork
        from texir_code_tpu_torch.models.tracer_pil import TracerPIL

        return TracerPIL(tbl, PILNetwork(generator=self.generator),
                         cluster_scene=self.cluster_scene,
                         spmd_mesh=self.spmd_mesh)

    @torch.no_grad()
    def validate(self, epoch: int, roughness_grid=(0.1, 0.3, 0.5, 0.7, 0.9),
                 val_spp: int = 512, n_points: int = 1024):
        """Prefiltered-radiance PSNR over a fixed roughness grid: at a fixed
        set of surface points (MeshPoint seed 4242), the network's
        prediction against an MC ground truth of `val_spp` samples traced
        at each grid roughness r (seed step_seed(50_000 + int(100 r)))."""
        from texir_code_tpu_torch.data.datasets import MeshPoint
        from texir_code_tpu_torch.ops.shading import (
            hdr_recover,
            mse_to_psnr,
            tonemap,
        )

        t0 = time.time()
        n_points = self.conf.get_int("val.pil_points", default=n_points)
        val_spp = self.conf.get_int("val.pil_spp", default=val_spp)
        val = MeshPoint(self.path_mesh, num_sample=n_points, seed=4242)
        pts, nrm = self._tensor(val.points), self._tensor(val.normals)
        self.val_metrics = {}
        psnrs = []
        for r in roughness_grid:
            rough = torch.full((pts.shape[0], 1), r, device=self.device)
            _, wo, gt = self.model.trace_gt(
                pts, nrm, val_spp, step_seed(50_000 + int(r * 100)), rough)
            pred = hdr_recover(self.model.network(pts, wo, rough))
            m = float(((tonemap(pred) - tonemap(gt)) ** 2).mean())
            p = float(mse_to_psnr(torch.tensor(m)))
            self.val_metrics[f"val_psnr_r{r:g}"] = p
            psnrs.append(p)
        self.val_metrics["val_psnr"] = float(np.mean(psnrs))
        self.timings["val_s"] = time.time() - t0
        self._log_val(epoch)
        return self.val_metrics
