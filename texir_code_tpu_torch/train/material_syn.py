"""MatSyn stage runner — Mat training + ground-truth material evaluation.

The port of the JAX package's `train/material_syn.py` (reference
trainer/train_material_syn.py):

  * scale-invariant albedo comparison through a least-squares scalar fit
    (`scale_compute`, reference utils/general.py:128-130);
  * albedo / roughness MSE, PSNR and SSIM against the GT atlases, after
    emitter texels take their GT values (`postprocessing_materials`,
    reference :374-392), over the full atlas, over the mapped texels only
    (a valid mask per GT resolution) and over the gutter-padded atlas;
  * the held-out novel views' re-render metrics (info/novel.txt), which
    the Mat runner's training-view filter keeps out of training.

`run` trains (MatTrainRunner.run), evaluates both, and writes the metrics
into the experiment's `timings.json` beside the stage's times.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from texir_code_tpu_torch.config import Config
from texir_code_tpu_torch.data import hdrio
from texir_code_tpu_torch.data.datasets import ImageCubeSyn
from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.train.material import MatTrainRunner


def scale_compute(gt: np.ndarray, prediction: np.ndarray) -> float:
    """Least-squares scalar s minimizing ||gt - s·pred|| (float64)."""
    p = prediction.reshape(-1).astype(np.float64)
    g = gt.reshape(-1).astype(np.float64)
    denom = float(p @ p)
    return float(p @ g) / denom if denom > 0 else 1.0


def postprocessing_materials(albedo: np.ndarray, roughness: np.ndarray,
                             gt_albedo: np.ndarray, gt_roughness: np.ndarray,
                             emitter_mask: np.ndarray) -> tuple:
    """Emitter texels take GT values: their reflectance is unobservable
    under their own emission (reference train_material_syn.py:374-392)."""
    m = emitter_mask[..., None] if emitter_mask.ndim == 2 else emitter_mask
    albedo = np.where(m > 0, gt_albedo, albedo)
    roughness = np.where(m > 0, gt_roughness, roughness)
    return albedo, roughness


def atlas_metrics(pred: np.ndarray, gt: np.ndarray, device) -> tuple:
    """(mse, psnr, ssim) of one atlas [H, W, C] against its GT, on
    `device`; a one-channel atlas is compared as three equal channels."""
    from texir_code_tpu_torch.models.losses import ssim
    from texir_code_tpu_torch.ops.shading import mse_to_psnr

    p = torch.as_tensor(np.asarray(pred, np.float32), device=device)[None]
    g = torch.as_tensor(np.asarray(gt, np.float32), device=device)[None]
    if p.shape[-1] == 1:
        p = p.repeat(1, 1, 1, 3)
        g = g.repeat(1, 1, 1, 3)
    mse = float(((p - g) ** 2).mean())
    return (mse, float(mse_to_psnr(torch.tensor(mse))), float(ssim(p, g)))


def _resample(x: np.ndarray, res_hw) -> np.ndarray:
    """Nearest resampling of an atlas to (h, w)."""
    rows = (np.arange(res_hw[0]) * x.shape[0]) // res_hw[0]
    cols = (np.arange(res_hw[1]) * x.shape[1]) // res_hw[1]
    return x[rows][:, cols]


class MatTrainSynRunner(MatTrainRunner):
    def __init__(self, conf: Config, **kw):
        resolve_device(kw.get("device", "cuda"))  # before reading the scan
        path_mesh = conf.get_string("train.path_mesh_open3d")
        pano_res = tuple(conf.get_list("train.pano_img_res",
                                       default=[256, 512]))
        hdr_exposure = conf.get_float("train.hdr_exposure", default=0.0)
        dataset = kw.pop("dataset", None) or ImageCubeSyn(
            path_mesh, resolution=pano_res, hdr_exposure=hdr_exposure)
        super().__init__(conf, dataset=dataset, **kw)

    def evaluate_materials(self, emitter_threshold: float = 0.5
                           ) -> Dict[str, float]:
        """GT-material metrics at the atlas level (reference :394-523)."""
        from texir_code_tpu_torch.ops.postprocess import pad_texture
        from texir_code_tpu_torch.ops.shading import mse_to_psnr

        ds = self.dataset
        if getattr(ds, "gt_albedo", None) is None:
            raise ValueError("dataset has no GT materials")
        gt_a, gt_r = ds.gt_albedo, ds.gt_roughness
        albedo, rough = self.atlases()
        albedo = _resample(albedo, gt_a.shape[:2])
        rough = _resample(rough, gt_r.shape[:2])

        # emitter texels take GT (postprocessing, :374-392)
        hdr_tex = hdrio.read_hdr(
            self.conf.get_string("train.path_mesh_open3d").replace(
                "out1.obj", "hdr_texture.hdr"), flip=True)
        intensity = (0.299 * hdr_tex[..., 0] + 0.587 * hdr_tex[..., 1]
                     + 0.114 * hdr_tex[..., 2])
        emitter = _resample((intensity >= emitter_threshold).astype(
            np.float32), gt_a.shape[:2])
        albedo, rough = postprocessing_materials(albedo, rough, gt_a, gt_r,
                                                 emitter)

        # scale-invariant albedo (:440)
        s = scale_compute(gt_a, albedo)
        albedo_s = np.clip(albedo * s, 0, 1)
        a_mse, a_psnr, a_ssim = atlas_metrics(albedo_s, gt_a, self.device)
        r_mse, r_psnr, r_ssim = atlas_metrics(rough, gt_r, self.device)
        out = {
            "albedo_scale": s,
            "albedo_mse": a_mse, "albedo_psnr": a_psnr, "albedo_ssim": a_ssim,
            "roughness_mse": r_mse, "roughness_psnr": r_psnr,
            "roughness_ssim": r_ssim,
        }

        # Mapped-texel metrics: the chart gutters no triangle maps are
        # unobservable, frozen at init while the GT atlas carries values
        # there.  A mask is baked at each GT's own resolution (albedo and
        # roughness atlases may differ).
        valid_a = self._valid_mask(gt_a.shape[0])
        valid_r = (valid_a if gt_r.shape[:2] == gt_a.shape[:2]
                   else self._valid_mask(gt_r.shape[0]))
        if (valid_a.shape == gt_a.shape[:2] and valid_a.any()
                and valid_r.shape == gt_r.shape[:2] and valid_r.any()):
            m_a = float(np.mean((albedo_s - gt_a)[valid_a] ** 2))
            m_r = float(np.mean((rough - gt_r)[valid_r] ** 2))
            out.update({
                "mapped_fraction": float(valid_a.mean()),
                "albedo_mse_mapped": m_a,
                "albedo_psnr_mapped": float(mse_to_psnr(torch.tensor(m_a))),
                "roughness_mse_mapped": m_r,
                "roughness_psnr_mapped": float(
                    mse_to_psnr(torch.tensor(m_r))),
            })
            # the full atlas after the nearest-mapped gutter fill (what a
            # consumer of the *_padding.hdr atlases sees)
            pa = atlas_metrics(pad_texture(albedo_s, valid_a), gt_a,
                               self.device)
            pr = atlas_metrics(pad_texture(rough, valid_r), gt_r,
                               self.device)
            out.update({
                "albedo_mse_padded": pa[0], "albedo_psnr_padded": pa[1],
                "albedo_ssim_padded": pa[2],
                "roughness_mse_padded": pr[0],
                "roughness_psnr_padded": pr[1],
                "roughness_ssim_padded": pr[2],
            })
        print("material eval:", out, flush=True)
        return out

    def evaluate_novel_views(self) -> Dict[str, float]:
        """Held-out novel-view re-render metrics (reference :394-523)."""
        from texir_code_tpu_torch.models.losses import ssim
        from texir_code_tpu_torch.ops.shading import mse_to_psnr, tonemap

        ds = self.dataset
        novel_ids = set(getattr(ds, "novel_ids", []))
        novel_idx = [i for i, vid in enumerate(ds.ids) if vid in novel_ids]
        if not novel_idx:
            return {}
        mse = psnr = ssim_v = 0.0
        for i in novel_idx:
            item = self._item(i)
            out = self._render(item, 2, 20_000 + i)
            pred = tonemap(out["rgb"])
            gt = tonemap(torch.as_tensor(item["color"], device=self.device))
            m = float(((pred - gt) ** 2).mean())
            mse += m
            psnr += float(mse_to_psnr(torch.tensor(m)))
            ssim_v += float(ssim(pred, gt))
        n = len(novel_idx)
        out = {"novel_mse": mse / n, "novel_psnr": psnr / n,
               "novel_ssim": ssim_v / n}
        print("novel-view eval:", out, flush=True)
        return out

    def run(self):
        params = super().run()
        t0 = time.time()
        self.material_metrics = self.evaluate_materials()
        t1 = time.time()
        self.novel_metrics = self.evaluate_novel_views()
        self.timings["evaluate_materials_s"] = t1 - t0
        self.timings["evaluate_novel_views_s"] = time.time() - t1
        if not self.exp.is_writer:
            return params
        with open(os.path.join(self.exp.root, "timings.json"), "w") as f:
            json.dump(dict(self.timings, metrics=self.metrics,
                           material_metrics=self.material_metrics,
                           novel_metrics=self.novel_metrics), f, indent=1)
        return params
