"""Runners of the baseline heads: InvRender, NeILF and nvdiffrec.

The port of the JAX package's `train/heads.py` (reference trainer/
train_material_{invrender,neilf,recMLP}[_syn].py, three structurally equal
loops that differ in the model and the loss) on one device: one
parameterised runner and its synthetic-GT variant.  Stage names follow the
reference CLI ('MatInv', 'MatNeilf', 'MatRec' and their '…Syn' forms,
trainer/exp_runner.py:59-66).

A step is forward + loss + backward + Adam over one view, at the learning
rate of `make_lr_schedule`; the global step index keys the step's draws and
drives nvdiffrec's ramp.  Each view's G-buffer and IrT irradiance are
computed once before the first epoch (`precompute_view`), as the JAX
runner hoists them out of its scanned epoch.  `timings.json` in the
experiment directory records the stage's times (set-up, views, steps, the
first step apart), the peak device memory on the card and, for the '…Syn'
runners, the evaluation's seconds and metrics.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from texir_code_tpu_torch.config import Config
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.datasets import ImageCubeDerived, ImageCubeSyn
from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.train import checkpoints as ckpt
from texir_code_tpu_torch.train.exp import (
    SEED,
    ExperimentDir,
    draw_seed,
    seed_everything,
)


def make_lr_schedule(lr: float, sched_step, factor: float,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of optimizer step k (from 0), the JAX package's
    optax schedule.  A scalar `sched_step` is the reference's StepLR period
    in epochs (staircase decay); a list holds MultiStepLR milestones in
    epochs, and duplicated milestones compound the factor, as torch counts
    them (syn_neilf.conf's [20, 20] × 0.2 gives 0.04 from epoch 20)."""
    if isinstance(sched_step, (list, tuple)):
        scales: Dict[int, float] = {}
        for m in sched_step:
            b = int(m) * steps_per_epoch
            scales[b] = scales.get(b, 1.0) * factor
        bounds = sorted(scales.items())

        def schedule(k: int) -> float:
            v = lr
            for b, s in bounds:
                if k >= b:
                    v *= s
            return v

        return schedule
    period = max(1, int(sched_step) * steps_per_epoch)
    return lambda k: lr * factor ** (k // period)


def head_adam(parameters, lr: float, sched_step, factor: float,
              steps_per_epoch: int):
    """torch.optim.Adam whose step k runs at make_lr_schedule's rate k:
    (optimizer, scheduler); call scheduler.step() after each
    optimizer.step()."""
    schedule = make_lr_schedule(lr, sched_step, factor, steps_per_epoch)
    opt = torch.optim.Adam(list(parameters), lr=lr)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: schedule(k) / lr)


class BaselineHeadRunner:
    """Single-stage trainer over one of the baseline heads.

    head: 'invrender' | 'neilf' | 'recmlp'.
    """

    STAGE_NAMES = {"invrender": "MatInv", "neilf": "MatNeilf",
                   "recmlp": "MatRec"}

    def __init__(
        self,
        conf: Config,
        head: str,
        expname: str = "default",
        exps_root: str = "exps",
        is_continue: bool = False,
        timestamp: Optional[str] = None,
        conf_path: Optional[str] = None,
        max_epochs: Optional[int] = None,
        dataset=None,
        model=None,
        device="cuda",
        stage: Optional[str] = None,
    ):
        """Args: as the other runners'; `model` a built head, `stage` the
        experiment directory's stage name (default STAGE_NAMES[head])."""
        from texir_code_tpu_torch.geometry import load_obj
        from texir_code_tpu_torch.models.material_heads import HEADS

        t0 = time.time()
        self.head = head.lower()
        if self.head not in self.STAGE_NAMES:
            raise ValueError(f"unknown head {head!r}")
        self.device = resolve_device(device)
        self.conf = conf
        self.expname = expname
        self.exp = ExperimentDir(
            exps_root, stage or self.STAGE_NAMES[self.head], expname,
            is_continue, timestamp, conf_path)
        self.writer = self.exp.writer()
        generator = seed_everything(SEED)
        self.timings: Dict = {}

        path_mesh = conf.get_string("train.path_mesh_open3d")
        pano_res = tuple(conf.get_list("train.pano_img_res",
                                       default=[256, 512]))
        hdr_exposure = conf.get_float("train.hdr_exposure", default=0.0)
        self.dataset = dataset or ImageCubeDerived(
            path_mesh, resolution=pano_res, hdr_exposure=hdr_exposure)
        if model is None:
            hdr_tex = hdrio.read_hdr(
                path_mesh.replace("out1.obj", "hdr_texture.hdr"), flip=True)
            irt = hdrio.read_hdr(path_mesh.replace("out1.obj", "irt.hdr"),
                                 flip=True)
            model = HEADS[self.head](
                load_obj(path_mesh), hdr_tex, irt, pano_res=pano_res,
                sample_light=tuple(conf.get_list("train.sample_light",
                                                 default=[32, 16])),
                hdr_exposure=hdr_exposure, device=self.device)
        self.model = model
        self.params = model.init_params(generator)

        self.nepochs = max_epochs or conf.get_int("train.mat_epoch",
                                                  default=40)
        self.optimizer, self.scheduler = head_adam(
            self.params.parameters(),
            conf.get_float("train.mat_learning_rate", default=3e-2),
            conf.get("train.mat_sched_step", 20),
            conf.get_float("train.mat_sched_factor", default=0.8),
            max(1, len(self.dataset)))
        loss_conf = conf.get("loss", None)
        self.inv_weights = {} if loss_conf is None else {
            k: loss_conf.get_float(k, default=d) for k, d in (
                ("sg_rgb_weight", 1.0), ("kl_weight", 0.01),
                ("latent_smooth_weight", 0.1))}
        self._sync()
        self.timings["setup_s"] = time.time() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _train_indices(self):
        ds = self.dataset
        train_ids = getattr(ds, "train_ids", None) or ds.ids
        return [i for i, vid in enumerate(ds.ids) if vid in train_ids]

    def prepare_views(self, indices):
        """Each view's step inputs on the device, with its G-buffer and
        IrT irradiance computed once."""
        views = []
        for i in indices:
            item = self.dataset[i]
            v = {k: torch.as_tensor(np.asarray(item[src]), dtype=torch.float32,
                                    device=self.device)
                 for k, src in (("mvp", "cam_to_world"),
                                ("pos", "cam_position"), ("gt", "color"),
                                ("grad", "rgb_grad"))}
            v["view"] = self.model.precompute_view(v["mvp"], v["pos"])
            views.append(v)
        return views

    def loss(self, out, v, it: int) -> torch.Tensor:
        from texir_code_tpu_torch.models import losses

        if self.head == "invrender":
            return losses.inv_loss(out, v["gt"], out["latent_pre_sigmoid"],
                                   **self.inv_weights)["loss"]
        if self.head == "neilf":
            return losses.neilf_loss(out, v["gt"], v["grad"])
        return losses.nvdiffrec_loss(out, v["gt"], it)

    def step(self, v, it: int) -> torch.Tensor:
        """One optimizer step on view v at global step `it`: the loss."""
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model._forward(self.params, v["mvp"], v["pos"],
                                  seed=draw_seed(it), view=v["view"])
        loss = self.loss(out, v, it)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return loss.detach()

    def _run_epochs(self, indices, tag: str):
        """`nepochs` epochs over the views `indices`; the losses [epochs,
        views] go to stdout, scalars.tsv and `self.losses`."""
        t0 = time.time()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        views = self.prepare_views(indices)
        self._sync()
        views_s = time.time() - t0
        step_s, first_step_s, all_losses = 0.0, None, []
        cur_iter = 0
        for epoch in range(self.nepochs):
            t1 = time.time()
            losses = []
            for bi, v in enumerate(views):
                losses.append(self.step(v, cur_iter + bi))
                if first_step_s is None:  # one-time costs land here
                    self._sync()
                    first_step_s = time.time() - t1
            losses = torch.stack(losses).cpu().numpy()
            dt = time.time() - t1  # ends in the device-to-host copy
            step_s += dt
            for bi, i in enumerate(indices):
                print(f"{self.expname} [{epoch}] ({i}/{len(indices)}): "
                      f"{tag} = {losses[bi]:.6f}, batch cost time : "
                      f"{dt / len(indices):.4f}s")
                self.writer.add_scalar(tag, float(losses[bi]), cur_iter + bi)
            cur_iter += len(indices)
            all_losses.append(losses)
        self.losses = np.stack(all_losses)
        steps = self.nepochs * len(indices)
        self.timings.update(
            views_s=views_s, steps=steps, step_s=step_s,
            first_step_s=first_step_s,
            ms_per_step=1e3 * step_s / max(steps, 1),
            steps_per_s=steps / step_s if step_s else 0.0,
            last_loss=float(self.losses[-1, -1]))
        if self.device.type == "cuda":
            self.timings["max_memory_allocated"] = int(
                torch.cuda.max_memory_allocated(self.device))
        print(f"{self.head}: {steps} steps in {step_s:.3f} s "
              f"({self.timings['ms_per_step']:.3f} ms a step; the first "
              f"{first_step_s:.3f} s); views prepared in {views_s:.3f} s",
              flush=True)

    def _finish(self, t0: float, **extra):
        if self.exp.is_writer:
            ckpt.save_checkpoint(self.exp.checkpoints_dir, self.nepochs,
                                 {"params": self.params.state_dict()})
        self.timings["run_s"] = time.time() - t0
        if self.exp.is_writer:
            with open(os.path.join(self.exp.root, "timings.json"), "w") as f:
                json.dump(dict(self.timings, **extra), f, indent=1)
        self.writer.close()

    def run(self):
        t0 = time.time()
        self._run_epochs(list(range(len(self.dataset))), f"{self.head}_loss")
        self._finish(t0)
        return self.params


def evaluate_head_materials_syn(runner: BaselineHeadRunner
                                ) -> Dict[str, float]:
    """Synthetic-GT material metrics of a head: its field queried at the
    world positions of the GT albedo atlas's texels
    (`bake_geometry_textures` at its resolution), compared with
    the GT atlases by MatSyn's scale-invariant albedo and roughness
    metrics, over the whole atlas and over the mapped texels (a mask
    resampled to each GT's own resolution)."""
    from texir_code_tpu_torch.models.tracer_irt import bake_geometry_textures
    from texir_code_tpu_torch.ops.shading import mse_to_psnr
    from texir_code_tpu_torch.train.material_syn import (
        _resample,
        atlas_metrics,
        scale_compute,
    )

    ds = runner.dataset
    if getattr(ds, "gt_albedo", None) is None:
        raise ValueError("synthetic evaluation needs an ImageCubeSyn "
                         "dataset with GT")
    texture_res = ds.gt_albedo.shape[0]
    geom = bake_geometry_textures(runner.model.mesh, texture_res)
    vr, vc = np.nonzero(geom.valid)
    pts = torch.as_tensor(geom.position[vr, vc], dtype=torch.float32,
                          device=runner.device)
    with torch.no_grad():
        albedo_f, rough_f = runner.model.query_materials(runner.params, pts)
    albedo = np.zeros((texture_res, texture_res, 3), np.float32)
    rough = np.zeros((texture_res, texture_res, 1), np.float32)
    albedo[vr, vc] = albedo_f.cpu().numpy()
    rough[vr, vc] = rough_f.cpu().numpy()

    gt_a, gt_r = ds.gt_albedo, ds.gt_roughness
    albedo = _resample(albedo, gt_a.shape[:2])
    rough = _resample(rough, gt_r.shape[:2])
    # gutter texels map no triangle: the field is never queried there
    mapped = np.asarray(geom.valid).astype(np.float32)[..., None]
    valid_a = _resample(mapped, gt_a.shape[:2])[..., 0] > 0
    valid_r = _resample(mapped, gt_r.shape[:2])[..., 0] > 0
    s = scale_compute(gt_a, albedo)
    albedo_s = np.clip(albedo * s, 0, 1)

    def psnr(m):
        return float(mse_to_psnr(torch.tensor(m)))

    a = atlas_metrics(albedo_s, gt_a, runner.device)
    r = atlas_metrics(rough, gt_r, runner.device)
    m_a = float(np.mean((albedo_s - gt_a)[valid_a] ** 2))
    m_r = float(np.mean((rough - gt_r)[valid_r] ** 2))
    out = {
        "albedo_scale": s,
        "albedo_mse": a[0], "albedo_psnr": a[1], "albedo_ssim": a[2],
        "roughness_mse": r[0], "roughness_psnr": r[1], "roughness_ssim": r[2],
        "mapped_fraction": float(valid_a.mean()),
        "albedo_mse_mapped": m_a, "albedo_psnr_mapped": psnr(m_a),
        "roughness_mse_mapped": m_r, "roughness_psnr_mapped": psnr(m_r),
    }
    print(f"{runner.head} material eval:", out, flush=True)
    return out


class BaselineHeadSynRunner(BaselineHeadRunner):
    """The synthetic-GT variant (reference trainer/train_material_
    {invrender,neilf,recMLP}_syn.py): train on the training views only
    (the novel views held out), then evaluate at `eval_spp` specular
    samples (the reference's `sample_l[1] = 256`, :431-435): re-render
    MSE/PSNR/SSIM over the training and the novel views, and the GT
    material metrics."""

    SYN_STAGE_NAMES = {"invrender": "MatInvSyn", "neilf": "MatNeilfSyn",
                       "recmlp": "MatRecSyn"}

    def __init__(self, conf, head, eval_spp: Optional[int] = 256, **kw):
        resolve_device(kw.get("device", "cuda"))  # before reading the scan
        dataset = kw.pop("dataset", None) or ImageCubeSyn(
            conf.get_string("train.path_mesh_open3d"),
            resolution=tuple(conf.get_list("train.pano_img_res",
                                           default=[256, 512])),
            hdr_exposure=conf.get_float("train.hdr_exposure", default=0.0))
        self.eval_spp = eval_spp
        super().__init__(conf, head, dataset=dataset,
                         stage=self.SYN_STAGE_NAMES[head.lower()], **kw)

    def run(self):
        t0 = time.time()
        self._run_epochs(self._train_indices(), f"{self.head}_syn_loss")
        t1 = time.time()
        self.metrics = self.evaluate()
        self._sync()
        self.timings["eval_s"] = time.time() - t1
        self._finish(t0, metrics=self.metrics)
        return self.params

    def evaluate(self) -> Dict[str, float]:
        """Re-render metrics at eval_spp and the GT material metrics."""
        from texir_code_tpu_torch.models.losses import ssim
        from texir_code_tpu_torch.ops.shading import mse_to_psnr, tonemap

        if self.eval_spp:
            self.model.sample_light = (self.model.sample_light[0],
                                       self.eval_spp)
        ds = self.dataset
        novel = set(getattr(ds, "novel_ids", []) or [])

        def render_metrics(indices, tag):
            if not indices:
                return {}
            mse = psnr = ssim_v = 0.0
            for i in indices:
                item = ds[i]
                with torch.no_grad():
                    out = self.model.forward(
                        self.params, item["cam_to_world"],
                        item["cam_position"], seed=draw_seed(30_000 + i))
                pred = tonemap(out["rgb"])
                gt = tonemap(torch.as_tensor(item["color"],
                                             device=self.device))
                m = float(((pred - gt) ** 2).mean())
                mse += m
                psnr += float(mse_to_psnr(torch.tensor(m)))
                ssim_v += float(ssim(pred, gt))
            n = len(indices)
            out = {f"{tag}_mse": mse / n, f"{tag}_psnr": psnr / n,
                   f"{tag}_ssim": ssim_v / n}
            print(f"{self.head} {tag} re-rendering error:", out, flush=True)
            return out

        metrics = {}
        metrics.update(render_metrics(self._train_indices(), "rerender"))
        metrics.update(render_metrics(
            [i for i, vid in enumerate(ds.ids) if vid in novel], "novel"))
        try:
            metrics.update(evaluate_head_materials_syn(self))
        except ValueError as e:
            # a broken GT load shows as NaN metrics, not as missing keys
            print(f"{self.head} material eval FAILED: {e}", flush=True)
            metrics.update({k: float("nan") for k in (
                "albedo_scale", "albedo_mse", "albedo_psnr", "albedo_ssim",
                "roughness_mse", "roughness_psnr", "roughness_ssim",
                "albedo_psnr_mapped", "roughness_psnr_mapped")})
        return metrics


def InvRenderTrainRunner(conf, **kw):
    return BaselineHeadRunner(conf, "invrender", **kw)


def NeILFTrainRunner(conf, **kw):
    return BaselineHeadRunner(conf, "neilf", **kw)


def NvDiffRecTrainRunner(conf, **kw):
    return BaselineHeadRunner(conf, "recmlp", **kw)


def MatInvTrainSynRunner(conf, **kw):
    return BaselineHeadSynRunner(conf, "invrender", **kw)


def MatNeilfTrainSynRunner(conf, **kw):
    return BaselineHeadSynRunner(conf, "neilf", **kw)


def MatRecMLPTrainSynRunner(conf, **kw):
    return BaselineHeadSynRunner(conf, "recmlp", **kw)
