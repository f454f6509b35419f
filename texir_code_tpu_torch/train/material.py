"""Mat stage runner — SVBRDF texture optimization with the 3-substage
schedule.

The port of the JAX package's `train/material.py` (reference
trainer/train_material.py:31-611) on one device:

  * first-val mask build (:245-318): each view rendered at stage -1 (the
    VHL emitter) → per-view highlight mask; seg-class ids from the dataset
    with the floor class eroded 15×15 (eroded-out pixels leave every
    class); per-room ids from the roomseg occupancy image at world xz;
  * run (:408-605): three substages over `mat_epoch` epochs × views — 0:
    albedo (Lambertian), 1: roughness (highlight-masked), 2: joint — each
    with a fresh Adam and the staircase learning-rate decay, the clamps
    after every step, then `save_materials` and `render_calculate`.

A step is forward render + loss + backward + Adam + clamp, one view at a
time (the JAX package scans the views of an epoch inside one jitted call;
PyTorch runs eagerly, so the scan is this Python loop).  Each view's
G-buffer and mip LODs are traced once per substage and reused by every
epoch (`_stack_epoch_data`).

`timings.json` in the experiment directory records where the stage's
wall time went: set-up (scene, model), dataset reads, mask pass, each
substage's steps, the material save and the re-render.
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
from texir_code_tpu_torch.data.datasets import ImageCubeDerived
from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.train import checkpoints as ckpt
from texir_code_tpu_torch.train.exp import ExperimentDir, seed_everything

NUM_SEG_CLASSES = 49  # the reference's seg tag range 0..48 (:188)
FLOOR_CLASS = 46      # seg_tag[-3] (:258)
SEED = 666


def parse_roomseg(path: str):
    """Room-segmentation metadata + id image (reference utils/general.py:
    115-125).  Returns (scale, w, h, x_min, z_min, room_img [H, W]) or
    None if absent."""
    meta = os.path.join(path, "originOccupancyGrid_f0.meta")
    img = os.path.join(path, "roomSegs_uchar_f0.png")
    if not (os.path.exists(meta) and os.path.exists(img)):
        return None
    with open(meta) as f:
        first = f.readline().strip().split(" ")
    scale, w, h, x_min, z_min = (float(x) for x in first[:5])
    return scale, w, h, x_min, z_min, hdrio.read_gray(img)


def room_ids_at(roomseg, positions: np.ndarray) -> np.ndarray:
    """Nearest room id at world xz (reference train_material.py:274-282)."""
    scale, w, h, x_min, z_min, img = roomseg
    u = (positions[..., 0] - x_min) / scale / w
    v = (positions[..., 2] - z_min) / scale / h
    cols = np.clip((u * img.shape[1]).astype(int), 0, img.shape[1] - 1)
    rows = np.clip((v * img.shape[0]).astype(int), 0, img.shape[0] - 1)
    return img[rows, cols].astype(np.int32)


def adam_for_substage(params, lr: float, sched_step: int, factor: float,
                      steps_per_epoch: int):
    """torch.optim.Adam over the atlases with the JAX package's optax
    schedule, `exponential_decay(lr, sched_step·steps_per_epoch, factor,
    staircase=True)`: step k uses lr·factor^floor(k / (sched_step·
    steps_per_epoch)).  Returns (optimizer, scheduler); call
    scheduler.step() after each optimizer.step()."""
    opt = torch.optim.Adam([params.albedo, params.roughness], lr=lr)
    period = max(1, sched_step * steps_per_epoch)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: factor ** (k // period)
    )
    return opt, sched


class MatTrainRunner:
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
        from texir_code_tpu_torch.geometry import load_obj
        from texir_code_tpu_torch.models.material import (
            MaterialModel,
            MaterialParams,
            init_material_params,
            render_knobs_from_conf,
        )

        t0 = time.time()
        self.device = resolve_device(device)
        if conf.get("train.atlas_tp", False) or conf.get("train.spmd") is True:
            raise NotImplementedError(
                "train.spmd / train.atlas_tp: the multi-device Mat step is "
                "not ported yet (ROADMAP.md queue A item 16)"
            )
        self.conf = conf
        self.expname = expname
        self.exp = ExperimentDir(
            exps_root, "Mat", expname, is_continue, timestamp, conf_path
        )
        self.writer = self.exp.writer()
        seed_everything(SEED)
        self.timings: Dict[str, float] = {"dataset_s": 0.0, "dataset_items": 0}

        path_mesh = conf.get_string("train.path_mesh_open3d")
        self.pano_res = tuple(conf.get_list("train.pano_img_res",
                                            default=[256, 512]))
        hdr_exposure = conf.get_float("train.hdr_exposure", default=0.0)
        self.dataset = ImageCubeDerived(path_mesh, resolution=self.pano_res,
                                        hdr_exposure=hdr_exposure)

        knobs = render_knobs_from_conf(conf)
        # the JAX runner's training defaults: stochastic-LOD + stochastic-
        # bilinear mip sampling (one texture gather per tap, unbiased) and
        # the proven occluders (exact); conf models.render.* overrides
        knobs.setdefault("mip_stochastic", True)
        if knobs.get("mip_stochastic"):
            knobs.setdefault("bilinear_stochastic", True)
        knobs.setdefault("use_occluders", True)
        mesh = load_obj(path_mesh)
        hdr_tex = hdrio.read_hdr(
            path_mesh.replace("out1.obj", "hdr_texture.hdr"), flip=True)
        irt = hdrio.read_hdr(path_mesh.replace("out1.obj", "irt.hdr"),
                             flip=True)
        self.model = MaterialModel(
            mesh, hdr_tex, irt, pano_res=self.pano_res,
            sample_light=tuple(conf.get_list("train.sample_light",
                                             default=[32, 16])),
            sample_type=tuple(conf.get_list("models.render.sample_type",
                                            default=["uniform", "importance"])),
            hdr_exposure=hdr_exposure, render_knobs=knobs, device=self.device,
        )
        self.params = init_material_params(
            conf.get_int("train.mat_albedo_res", default=2048),
            conf.get_int("train.mat_roughness_res", default=4096),
            device=self.device,
        )
        if self.exp.continued:
            restored = ckpt.restore_checkpoint(
                self.exp.checkpoints_dir,
                {"albedo": self.params.albedo, "roughness": self.params.roughness},
            )
            if restored is not None:
                self.params = MaterialParams(
                    albedo=restored["albedo"].to(self.device),
                    roughness=restored["roughness"].to(self.device),
                )

        # per-view G-buffer/LOD cache budget: ~12 fp32 per pixel, so
        # n_views · 6 · cube_res² · 48 B (~5 MB a view at pano 256×512)
        self.view_cache_budget = int(
            conf.get_float("train.view_cache_budget_mb", default=2048.0) * 2**20
        )
        self.nepochs = max_epochs or conf.get_int("train.mat_epoch", default=40)
        self.lr = conf.get_float("train.mat_learning_rate", default=3e-2)
        self.sched_step = conf.get_int("train.mat_sched_step", default=20)
        self.sched_factor = conf.get_float("train.mat_sched_factor", default=0.8)
        self.plot_freq = conf.get_int("train.plot_freq", default=10)
        self.loss_type = conf.get_string("render_loss.loss_type", default="L1")
        self.seg_weight_scale = conf.get_float(
            "render_loss.seg_weight_scale", default=1.0)
        self.pad_materials = conf.get_bool("train.pad_materials", default=True)
        self.roomseg = parse_roomseg(os.path.join(
            os.path.dirname(os.path.dirname(path_mesh)), "roomseg"))
        self.masks: Dict[str, Dict[str, np.ndarray]] = {}
        self._valid_cache: Dict[int, np.ndarray] = {}
        self._sync()
        self.timings["setup_s"] = time.time() - t0

    # ------------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def step_seed(n: int) -> int:
        """The draw seed of the runner's n-th keyed call (the JAX runner
        folds n into PRNGKey(666)): steps use their global iteration,
        the mask pass view i, re-renders 10_000 + i, plots 30_000 + i."""
        return (SEED << 24) + n

    def _item(self, i: int):
        t0 = time.time()
        item = self.dataset[i]
        self.timings["dataset_s"] += time.time() - t0
        self.timings["dataset_items"] += 1
        return item

    def _render(self, item, stage: int, n: int):
        with torch.no_grad():
            return self.model._forward(
                self.params, item["cam_to_world"], item["cam_position"],
                stage, seed=self.step_seed(n))

    def _valid_mask(self, res: int) -> np.ndarray:
        """[res, res] bool mapped-texel mask, cached per resolution."""
        cached = self._valid_cache.get(res)
        if cached is None:
            from texir_code_tpu_torch.models.tracer_irt import (
                bake_geometry_textures,
            )

            cached = np.asarray(
                bake_geometry_textures(self.model.mesh, res).valid, bool)
            self._valid_cache[res] = cached
        return cached

    def _train_indices(self):
        """Dataset indices used for training: a synthetic dataset holds out
        the novel views listed in info/novel.txt."""
        ds = self.dataset
        train_ids = getattr(ds, "train_ids", None)
        if train_ids is None:
            return list(range(len(ds)))
        return [i for i, vid in enumerate(ds.ids) if vid in set(train_ids)]

    def build_masks(self):
        """First-val pass (reference :245-318): VHL render per view →
        highlight masks; seg ids with the floor eroded; room ids."""
        from scipy import ndimage

        from texir_code_tpu_torch.ops.shading import rgb_to_intensity

        for i in self._train_indices():
            item = self._item(i)
            out = self._render(item, -1, i)
            intensity = rgb_to_intensity(out["rgb"].abs()).cpu().numpy()
            highlight = (intensity > 0.0).astype(np.float32)  # (:286-290)

            seg_id = np.clip(item["segs"][..., 0].astype(np.int32), 0,
                             NUM_SEG_CLASSES - 1)
            # erode the floor class 15×15; eroded-out pixels leave every class
            floor = (seg_id == FLOOR_CLASS).astype(np.uint8)
            if floor.any():
                er = np.stack([ndimage.grey_erosion(f, size=(15, 15))
                               for f in floor])
                seg_id = np.where((floor > 0) & (er == 0), NUM_SEG_CLASSES,
                                  seg_id)
            region = (seg_id < NUM_SEG_CLASSES).astype(np.float32)[..., None]
            if self.roomseg is not None:
                room_id = room_ids_at(self.roomseg,
                                      out["position"].cpu().numpy())
                n_rooms = int(room_id.max()) + 1
            else:
                room_id = np.zeros(seg_id.shape, np.int32)
                n_rooms = 1
            self.masks[item["id"]] = {
                "highlight": highlight, "seg_id": seg_id.astype(np.int32),
                "seg_region": region, "room_id": room_id, "n_rooms": n_rooms,
            }
        if self.roomseg is not None and self.masks:
            n = max(m["n_rooms"] for m in self.masks.values())
            print(f"roomseg active: n_rooms={n} — stage-2 seg prior runs "
                  f"per (room x class) [mode 2]", flush=True)

    def _stack_epoch_data(self, indices):
        """Each training view's tensors on the device, with its G-buffer
        and LODs traced once (`precompute_view`) unless the cache would
        exceed view_cache_budget bytes.  Returns (views, n_rooms): the room
        count is the scene's (the max over views), as the JAX runner's."""
        dev = self.device
        res = self.model.cube_res
        cache = len(indices) * 6 * res * res * 12 * 4 <= self.view_cache_budget
        if not cache:
            print("per-view cache exceeds view_cache_budget_mb — "
                  "recomputing G-buffers in-step")
        views, n_rooms = [], 1
        for i in indices:
            item = self._item(i)
            m = self.masks[item["id"]]
            n_rooms = max(n_rooms, m["n_rooms"])

            def t(x, dtype=torch.float32):
                return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

            v = dict(
                id=item["id"], mvp=t(item["cam_to_world"]),
                pos=t(item["cam_position"]), gt=t(item["color"]),
                mask=t(item["mask"]),
                seg=t(m["seg_id"], torch.int64), hl=t(m["highlight"]),
                region=t(m["seg_region"]), room=t(m["room_id"], torch.int64),
            )
            v["view"] = (self.model.precompute_view(self.params, v["mvp"],
                                                    v["pos"])
                         if cache else None)
            views.append(v)
        return views, n_rooms

    def _step(self, stage, v, n_rooms, it, optimizer, scheduler):
        from texir_code_tpu_torch.models.losses import render_loss
        from texir_code_tpu_torch.models.material import clamp_material_params

        optimizer.zero_grad(set_to_none=True)
        out = self.model._forward(self.params, v["mvp"], v["pos"], stage,
                                  seed=self.step_seed(it), view=v["view"])
        total, seg_term = render_loss(
            v["gt"], out, v["mask"], v["seg"], NUM_SEG_CLASSES + 1, stage,
            highlight=v["hl"], seg_region=v["region"], room_id=v["room"],
            num_rooms=n_rooms, loss_type=self.loss_type,
            seg_weight_scale=self.seg_weight_scale,
        )
        total.backward()
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            c = clamp_material_params(self.params)
            self.params.albedo.copy_(c.albedo)
            self.params.roughness.copy_(c.roughness)
        return total.detach(), seg_term.detach()

    def _substage(self, stage: int, epochs: int, cur_iter: int) -> int:
        """One substage: `epochs` epochs over the training views with a
        fresh Adam; returns the next global iteration."""
        t0 = time.time()
        indices = self._train_indices()
        views, n_rooms = self._stack_epoch_data(indices)
        self._sync()
        t1 = time.time()
        for p in (self.params.albedo, self.params.roughness):
            p.requires_grad_(True)
        optimizer, scheduler = adam_for_substage(
            self.params, self.lr, self.sched_step, self.sched_factor,
            max(1, len(indices)))
        views_s, optim_s = t1 - t0, time.time() - t1
        step_s, first_step_s = 0.0, None
        for epoch in range(epochs):
            t1 = time.time()
            losses = []
            for bi, v in enumerate(views):
                losses.append(self._step(stage, v, n_rooms, cur_iter + bi,
                                         optimizer, scheduler))
                if first_step_s is None:  # one-time costs land here
                    self._sync()
                    first_step_s = time.time() - t1
            losses = torch.stack([torch.stack(x) for x in losses]).cpu().numpy()
            dt = time.time() - t1  # ends in the device-to-host copy
            step_s += dt
            for bi, i in enumerate(indices):
                print(
                    f"{self.expname} [{epoch}] ({i}/{len(self.dataset)}): "
                    f"img_loss_stage{stage} ({self.loss_type}) = "
                    f"{losses[bi, 0]:.6f}, seg_loss = {losses[bi, 1]:.6f}, "
                    f"id = {views[bi]['id']}, batch cost time : "
                    f"{dt / len(indices):.4f}s"
                )
                self.writer.add_scalar(
                    f"img_loss_{self.loss_type}_stage{stage}",
                    losses[bi, 0], cur_iter + bi)
                self.writer.add_scalar(
                    f"seg_loss_{self.loss_type}_stage{stage}",
                    losses[bi, 1], cur_iter + bi)
            cur_iter += len(indices)
            if self.plot_freq and (epoch + 1) % self.plot_freq == 0:
                self.plot_to_disk(stage, f"s{stage}_e{epoch}")
        for p in (self.params.albedo, self.params.roughness):
            p.requires_grad_(False)
            p.grad = None
        steps = epochs * len(indices)
        self.timings[f"substage{stage}"] = dict(
            steps=steps, step_s=step_s, first_step_s=first_step_s,
            views_s=views_s, optim_s=optim_s,
            it_per_s=steps / step_s if step_s else 0.0,
            last_loss=float(losses[-1, 0]),
        )
        print(f"substage {stage}: {steps} steps in {step_s:.3f} s "
              f"({steps / max(step_s, 1e-9):.3f} it/s; the first "
              f"{first_step_s:.3f} s); views prepared in {views_s:.3f} s, "
              f"Adam made in {optim_s:.3f} s", flush=True)
        return cur_iter

    # ------------------------------------------------------------------
    def plot_to_disk(self, stage: int, tag: str):
        """Pano plots of prediction vs GT (reference plot_to_disk_cube)."""
        from texir_code_tpu_torch.ops.pano import PanoCubeWarp

        warp = PanoCubeWarp(self.pano_res[0], self.pano_res[1],
                            self.model.cube_res, device=self.device)
        for i in range(len(self.dataset)):
            item = self._item(i)
            out = self._render(item, stage, 30_000 + i)
            pred = warp.to_pano(out["rgb"]).cpu().numpy()
            gt = warp.to_pano(torch.as_tensor(item["color"],
                                              device=self.device)).cpu().numpy()
            hdrio.plot_irf(os.path.join(self.exp.plots_dir, f"{i}_{tag}.hdr"),
                           pred, gt)

    def save_materials(self, tag: str = "final"):
        """Write the optimized atlases to plots/ (what the testers read),
        their gutter-padded copies, and a checkpoint."""
        albedo = self.params.albedo.detach().cpu().numpy()
        rough = self.params.roughness.detach().cpu().numpy()
        hdrio.write_hdr(os.path.join(self.exp.plots_dir,
                                     f"mat_albedo_{tag}.hdr"), albedo)
        hdrio.write_hdr(os.path.join(self.exp.plots_dir,
                                     f"mat_roughness_{tag}.hdr"), rough)
        if self.pad_materials:
            from texir_code_tpu_torch.ops.postprocess import pad_texture

            for name, tex in (("albedo", albedo), ("roughness", rough)):
                hdrio.write_hdr(
                    os.path.join(self.exp.plots_dir,
                                 f"mat_{name}_{tag}_padding.hdr"),
                    pad_texture(tex, self._valid_mask(tex.shape[0])),
                )
        ckpt.save_checkpoint(self.exp.checkpoints_dir, 0,
                             {"albedo": albedo, "roughness": rough})

    def render_calculate(self, stage: int = 2) -> Dict[str, float]:
        """Tonemapped re-render MSE/PSNR/SSIM over the views
        (reference :359-406)."""
        from texir_code_tpu_torch.models.losses import ssim
        from texir_code_tpu_torch.ops.shading import mse_to_psnr, tonemap

        mse = psnr = ssim_v = 0.0
        n = len(self.dataset)
        for i in range(n):
            item = self._item(i)
            out = self._render(item, stage, 10_000 + i)
            pred = tonemap(out["rgb"])
            gt = tonemap(torch.as_tensor(item["color"], device=self.device))
            m = float(((pred - gt) ** 2).mean())
            mse += m
            psnr += float(mse_to_psnr(torch.tensor(m)))
            ssim_v += float(ssim(pred, gt))
        metrics = {"mse": mse / n, "psnr": psnr / n, "ssim": ssim_v / n}
        print("re-rendering error: mse: {mse}, psnr: {psnr}, ssim: {ssim}"
              .format(**metrics))
        return metrics

    def run(self):
        print("training...")
        t0 = time.time()
        self.build_masks()  # the reference's plot_to_disk_cube(stage=0) pass
        self._sync()
        self.timings["masks_s"] = time.time() - t0
        cur_iter = 0
        # stage 0: albedo (Lambertian init); 1: roughness via highlights;
        # 2: joint — each with a fresh Adam (reference :471-476, :538-)
        for stage in (0, 1, 2):
            cur_iter = self._substage(stage, self.nepochs, cur_iter)
        t1 = time.time()
        self.save_materials()
        self.timings["save_s"] = time.time() - t1
        t2 = time.time()
        self.metrics = self.render_calculate(2)
        self.timings["render_calculate_s"] = time.time() - t2
        self.timings["run_s"] = time.time() - t0
        with open(os.path.join(self.exp.root, "timings.json"), "w") as f:
            json.dump(dict(self.timings, metrics=self.metrics), f, indent=1)
        self.writer.close()
        return self.params
