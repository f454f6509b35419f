"""IRRF stage runner — NIrF training — and the loop the field stages share.

The port of the JAX package's `train/irrf.py` (reference
trainer/train_irrf.py:28-276): each epoch resamples the surface points,
traces the MC irradiance ground truth against the TBL and fits the
log-domain MLP; the runner validates by rendering the irradiance pano of a
fixed view (its GT traced once and cached, :187-231) and checkpoints.

The JAX runner scans an epoch's full batches in one jitted call and runs a
ragged tail alone; here PyTorch runs eagerly, so the scan is a Python loop
over the same batches in the same order, and the losses come to the host
once an epoch.  Step n draws with seed `step_seed(n)` and rows keyed by the
global point id, as the baker and the Mat runner do.

Conf knobs (reference configs/irrf_hdrhouse.conf): irf_epoch,
irf_learning_rate, irf_sched_step/factor (the staircase decay over
optimizer steps), samples_point_mesh, batch_size, env_res, val.env_res,
val_sample_res, std_jit, hdr_exposure, is_hdr_texture, plot_freq,
ckpt_freq, irf_loss.loss_type.

`timings.json` in the experiment directory records the stage's seconds
(set-up, training, validation and its GT trace) and the last val metrics.

With more than one rank (train.spmd "auto", the default) or train.spmd =
true, the GT traces are split over the ranks (the tracers' `spmd_mesh`)
and every rank steps its replicated network on the gathered GT; rank 0
writes the files.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from texir_code_tpu_torch.config import Config
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.datasets import ImageMeshPoint, MeshPoint
from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.train import checkpoints as ckpt
from texir_code_tpu_torch.train.exp import (
    SEED,
    ExperimentDir,
    adam_staircase,
    seed_everything,
)
from texir_code_tpu_torch.train.exp import draw_seed as step_seed


def pano_metrics(pred: np.ndarray, gt: np.ndarray, device) -> Dict[str, float]:
    """Tonemapped MSE / PSNR and, when the pano is at least 11 pixels on a
    side (the SSIM window), SSIM of two [H, W, 3] panos."""
    from texir_code_tpu_torch.models.losses import ssim
    from texir_code_tpu_torch.ops.shading import mse_to_psnr, tonemap

    p_tm = tonemap(torch.as_tensor(pred, device=device))
    g_tm = tonemap(torch.as_tensor(gt, device=device))
    m = float(((p_tm - g_tm) ** 2).mean())
    out = {"val_mse": m, "val_psnr": float(mse_to_psnr(torch.tensor(m)))}
    if min(pred.shape[:2]) >= 11:
        out["val_ssim"] = float(ssim(p_tm[None], g_tm[None]))
    return out


class FieldRunner:
    """A field stage's runner: the scene (mesh, TBL, the lb-8 ClusterScene
    the GT trace walks), the surface-point dataset, Adam with the staircase
    decay, the epoch loop, checkpoints and `timings.json`.  A stage gives
    `_build_model`, `_loss` and `validate`."""

    STAGE = "IRRF"
    LOSS_TAG = "irf_loss"

    def __init__(
        self,
        conf: Config,
        expname: str = "default",
        exps_root: str = "exps",
        is_continue: bool = False,
        timestamp: Optional[str] = None,
        conf_path: Optional[str] = None,
        max_epochs: Optional[int] = None,
        device="cuda",
    ):
        from texir_code_tpu_torch.geometry import build_bvh, load_obj
        from texir_code_tpu_torch.models.tbl import build_tbl_from_flat
        from texir_code_tpu_torch.ops.fan_raycast import FanScene
        from texir_code_tpu_torch.ops.pallas_culled import ClusterScene
        from texir_code_tpu_torch.parallel.mesh import (
            parallel_meshes_from_conf,
        )

        t0 = time.time()
        self.device = resolve_device(device)
        self.spmd_mesh, _ = parallel_meshes_from_conf(conf, self.device)
        self.conf = conf
        self.expname = expname
        self.exp = ExperimentDir(
            exps_root, self.STAGE, expname, is_continue, timestamp, conf_path
        )
        self.writer = self.exp.writer()
        self.generator = seed_everything(SEED)
        self.timings: Dict[str, float] = {}

        self.path_mesh = conf.get_string("train.path_mesh_open3d")
        mesh = load_obj(self.path_mesh)
        hdr_exposure = conf.get_float("train.hdr_exposure", default=0.0)
        if conf.get_bool("train.is_hdr_texture", default=True):
            tex = hdrio.read_hdr(
                self.path_mesh.replace("out1.obj", "hdr_texture.hdr"),
                flip=True)
        else:
            tex = hdrio.read_image(
                self.path_mesh.replace("out1.obj", "texture.png")) ** 2.2
        flat = build_bvh(mesh.vertices, mesh.faces)
        tbl = build_tbl_from_flat(flat, mesh, tex, hdr_exposure,
                                  device=self.device)
        fan = FanScene.from_flat(flat, triangle_uvs=mesh.triangle_uvs())
        self.cluster_scene = ClusterScene.from_fan(fan, lb=8, dense=True,
                                                   device=self.device)
        self.model = self._build_model(tbl)
        self.model.network.to(self.device)

        self.train_dataset = MeshPoint(
            self.path_mesh,
            num_sample=conf.get_int("train.samples_point_mesh", default=1024),
        )
        self.batch_size = conf.get_int("train.batch_size", default=16)
        self.env_res = tuple(conf.get_list("train.env_res", default=[32, 64]))
        self.nepochs = max_epochs or conf.get_int("train.irf_epoch",
                                                  default=4000)
        self.steps_per_epoch = max(1, len(self.train_dataset)
                                   // self.batch_size)
        self.optimizer, self.scheduler = adam_staircase(
            self.model.network.parameters(),
            conf.get_float("train.irf_learning_rate", default=1e-4),
            conf.get_int("train.irf_sched_step", default=800),
            conf.get_float("train.irf_sched_factor", default=0.8),
            self.steps_per_epoch,
        )
        self.start_epoch = 0
        if self.exp.continued:
            restored = ckpt.restore_checkpoint(self.exp.checkpoints_dir, {
                "network": {}, "optimizer": {}, "scheduler": {}, "epoch": 0})
            if restored is not None:
                self.model.network.load_state_dict(restored["network"])
                self.optimizer.load_state_dict(restored["optimizer"])
                self.scheduler.load_state_dict(restored["scheduler"])
                self.start_epoch = int(restored["epoch"]) + 1
        self._sync()
        self.timings["setup_s"] = time.time() - t0

    def _build_model(self, tbl):
        raise NotImplementedError

    def _loss(self, points, normals, seed, row_ids) -> torch.Tensor:
        raise NotImplementedError

    def validate(self, epoch: int) -> Dict[str, float]:
        raise NotImplementedError

    def _epochs(self):
        return range(self.start_epoch, self.nepochs)

    def _after_epoch(self, epoch: int, it0: int, it1: int) -> None:
        """Cadenced work after the epoch that ran steps it0..it1-1."""

    def _log_val(self, epoch: int) -> None:
        print(f"{self.STAGE} val [{epoch}]:", self.val_metrics, flush=True)
        for k, v in self.val_metrics.items():
            self.writer.add_scalar(k, v, epoch)

    # ------------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    def train_step(self, points, normals, it: int, row_ids) -> torch.Tensor:
        """One optimizer step on a batch (points / normals [B, 3] on the
        device, row_ids their global ids) with step n = `it`'s draws;
        returns the loss, on the device."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(points, normals, step_seed(it), row_ids)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return loss.detach()

    def train_epoch(self, it0: int) -> np.ndarray:
        """The current point set's batches in order, steps it0, it0+1, …;
        returns their losses (one device-to-host copy)."""
        pts = self._tensor(self.train_dataset.points)
        nrm = self._tensor(self.train_dataset.normals)
        ids = torch.arange(pts.shape[0], device=self.device)
        losses = []
        for bi, s in enumerate(range(0, pts.shape[0], self.batch_size)):
            sl = slice(s, s + self.batch_size)
            losses.append(self.train_step(pts[sl], nrm[sl], it0 + bi,
                                          ids[sl]))
        return torch.stack(losses).cpu().numpy()

    def _checkpoint(self, epoch: int) -> None:
        if not self.exp.is_writer:
            return
        ckpt.save_checkpoint(self.exp.checkpoints_dir, epoch, {
            "network": self.model.network.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "epoch": epoch,
        })

    def run(self):
        t_run = time.time()
        cur_iter = self.start_epoch * self.steps_per_epoch
        train_s, steps, self.epoch_losses = 0.0, 0, []
        for epoch in self._epochs():
            self.train_dataset.change_points()  # reference :238
            t0 = time.time()
            losses = self.train_epoch(cur_iter)  # ends in the host copy
            dt = time.time() - t0
            train_s += dt
            steps += len(losses)
            self.epoch_losses.append(losses)
            for bi, loss in enumerate(losses):
                it = cur_iter + bi
                if it % 50 == 0:
                    print(f"{self.expname} [{epoch}] ({bi}): {self.LOSS_TAG}"
                          f" = {float(loss):.6f}, batch cost time: "
                          f"{dt / len(losses):.4f}s", flush=True)
                    self.writer.add_scalar(self.LOSS_TAG, float(loss), it)
            self._after_epoch(epoch, cur_iter, cur_iter + len(losses))
            cur_iter += len(losses)
        self._checkpoint(self.nepochs)
        self.validate(self.nepochs)  # the final convergence metric
        self.timings.update(
            train_s=train_s, steps=steps,
            last_loss=float(self.epoch_losses[-1][-1]) if steps else None,
            ms_per_step=1e3 * train_s / max(steps, 1),
            steps_per_s=steps / train_s if train_s else 0.0,
            run_s=time.time() - t_run,
        )
        if self.exp.is_writer:
            with open(os.path.join(self.exp.root, "timings.json"), "w") as f:
                json.dump(dict(self.timings, val_metrics=self.val_metrics),
                          f, indent=1)
        self.writer.close()
        return self.model.network


class IRRFTrainRunner(FieldRunner):
    """NIrF: the irradiance MLP against the traced MC irradiance."""

    STAGE = "IRRF"
    LOSS_TAG = "irf_loss"

    def _build_model(self, tbl):
        from texir_code_tpu_torch.models.fields import MatNetwork
        from texir_code_tpu_torch.models.tracer_irrf import TracerIRRF

        c = "models.irrf_network."
        network = MatNetwork(
            points_multires=self.conf.get_int(c + "points_multires",
                                              default=10),
            dims=tuple(self.conf.get_list(c + "dims", default=[512] * 4)),
            p_out_dim=self.conf.get_int(c + "p_out_dim", default=3),
            generator=self.generator,
        )
        self.val_res = tuple(self.conf.get_list("val.env_res",
                                                default=[64, 128]))
        self.val_sample_res = tuple(self.conf.get_list(
            "train.val_sample_res", default=[32, 64]))
        self.loss_type = self.conf.get_string("irf_loss.loss_type",
                                              default="L1")
        self.plot_freq = self.conf.get_int("train.plot_freq", default=10000)
        self.ckpt_freq = self.conf.get_int("train.ckpt_freq", default=20000)
        self._val = None
        self._val_gt = None
        return TracerIRRF(
            tbl, network,
            std_jit=self.conf.get_float("train.std_jit", default=5e-2),
            cluster_scene=self.cluster_scene, spmd_mesh=self.spmd_mesh,
        )

    def _epochs(self):
        return range(self.start_epoch, self.nepochs + 1)  # as the JAX runner

    def _loss(self, points, normals, seed, row_ids):
        from texir_code_tpu_torch.models.losses import irf_loss

        gt = self.model.trace_gt(points, normals, self.env_res, seed, row_ids)
        return irf_loss(gt, self.model.network(points), self.loss_type)

    def _after_epoch(self, epoch, it0, it1):
        # validation: once an epoch holding a plot_freq multiple (the
        # reference validates mid-epoch at the exact iteration)
        if (self.plot_freq > 0 and epoch > self.start_epoch
                and it0 // self.plot_freq != it1 // self.plot_freq):
            self.validate(epoch)
        if epoch % max(self.ckpt_freq // self.steps_per_epoch, 1) == 0:
            self._checkpoint(epoch)

    @torch.no_grad()
    def val_gt(self) -> np.ndarray:
        """The val view's GT irradiance pano [H, W, 3], traced once: 512
        pixels a batch, batch j with seed step_seed(j) and rows keyed by
        the pixel id (the JAX runner folds j into its key)."""
        if self._val is None:
            t0 = time.time()
            self._val = ImageMeshPoint(self.path_mesh, env_res=self.val_res,
                                       device=self.device)
            self.timings["val_dataset_s"] = time.time() - t0
        if self._val_gt is None:
            t0 = time.time()
            pts = self._tensor(self._val.points)
            nrm = self._tensor(self._val.normals)
            ids = torch.arange(pts.shape[0], device=self.device)
            gts = [self.model.trace_gt(pts[s:s + 512], nrm[s:s + 512],
                                       self.val_sample_res, step_seed(j),
                                       ids[s:s + 512])
                   for j, s in enumerate(range(0, pts.shape[0], 512))]
            h, w = self.val_res
            self._val_gt = torch.cat(gts).cpu().numpy().reshape(h, w, 3)
            self.timings["val_gt_s"] = time.time() - t0
        return self._val_gt

    def validate(self, epoch: int):
        """The irradiance pano of the fixed val view against its cached GT,
        with PSNR / SSIM of the tonemapped panos (the JAX runner's
        field-stage convergence metric)."""
        gt = self.val_gt()
        t0 = time.time()
        h, w = self.val_res
        pred = self.model.predict_irradiance(
            self._tensor(self._val.points)).cpu().numpy().reshape(h, w, 3)
        if self.exp.is_writer:
            hdrio.plot_irf(os.path.join(self.exp.plots_dir,
                                        f"irrf_{epoch}.hdr"), pred, gt)
        self.val_metrics = pano_metrics(pred, gt, self.device)
        self.timings["val_s"] = time.time() - t0
        self._log_val(epoch)
        return pred, gt
