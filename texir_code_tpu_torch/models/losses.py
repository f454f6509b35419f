"""Losses of the Mat and field stages and the baseline heads (the port
of the JAX package's `models/losses.py`, reference models/loss.py).

Segmentation is carried as an integer class-id image, and every per-class
statistic (means, counts, quantiles) is a segment reduction (`index_add`),
so no [classes, pixels] one-hot expansion is built.  The loss values keep
the reference's formulas and normalizations:

  * ``irf_loss`` / ``IRFLoss`` — models/loss.py:28-52 (the field stages);
  * ``render_loss`` stages 0/1/2 — models/loss.py:81-115;
  * ``seg_loss`` modes 0/1/2 — :214-295 (class-mean pull, highlight-
    quantile roughness propagation, per-room variant);
  * ``tv_loss`` — :176-212 (eroded-mask total variation);
  * ``kl_divergence`` / ``inv_loss``, ``neilf_loss``, ``nvdiffrec_loss``
    (and the aliases ``InvLoss`` / ``NeILFLoss`` / ``NvDiffRecLoss``) —
    :297-466, the baseline heads' objectives;
  * ``ssim`` — :117-140 (pytorch_msssim defaults), with its Gaussian blur
    in full fp32: a reduced-precision blur (TF32 or bf16) cancels
    catastrophically in mu_aa - mu_a² and was measured to push SSIM to ~2;
    ``ms_ssim`` (pytorch_msssim MS_SSIM defaults), ``gradient_loss``
    (:154-173), ``psnr_loss`` / ``ssim_loss`` / ``msssim_loss``;
  * ``RenderLoss`` — the reference's class interface over ``render_loss``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from texir_code_tpu_torch.ops.sampling import TINY_NUMBER
from texir_code_tpu_torch.ops.shading import hdr_scale, mse_to_psnr


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def irf_loss(gt: torch.Tensor, pred: torch.Tensor,
             loss_type: str = "L1") -> torch.Tensor:
    """NIrF loss: |hdr_scale(gt) - pred| — the MLP predicts in log domain
    (reference models/loss.py:41-52)."""
    fn = l1 if loss_type == "L1" else l2
    return fn(hdr_scale(gt), pred)


class IRFLoss:
    """Callable wrapper with the reference class's interface."""

    def __init__(self, loss_type: str = "L1"):
        self.loss_type = loss_type

    def __call__(self, res: Dict[str, torch.Tensor]) -> torch.Tensor:
        return irf_loss(res["gt"], res["pred"], self.loss_type)


# ---------------------------------------------------------------------------
# SSIM
# ---------------------------------------------------------------------------


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of [N, H, W, C] images, valid padding: along
    W, then along H, per channel, in fp32 (the caller keeps TF32 off)."""
    c = img.shape[-1]
    k = kernel.shape[0]
    x = img.permute(0, 3, 1, 2)
    x = F.conv2d(x, kernel.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    x = F.conv2d(x, kernel.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return x.permute(0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         nonnegative: bool = True) -> torch.Tensor:
    """Mean SSIM over [N, H, W, C] images (11×11 Gaussian, K=(0.01, 0.03))."""
    kernel = _gaussian_kernel(device=a.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _blur(a, kernel)
    mu_b = _blur(b, kernel)
    mu_aa = _blur(a * a, kernel)
    mu_bb = _blur(b * b, kernel)
    mu_ab = _blur(a * b, kernel)
    var_a = mu_aa - mu_a ** 2
    var_b = mu_bb - mu_b ** 2
    cov = mu_ab - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    )
    if nonnegative:
        s = torch.clamp_min(s, 0.0)
    return s.mean()


def ms_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
            weights=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)) -> torch.Tensor:
    """Multi-scale SSIM over [N, H, W, C] images (pytorch_msssim MS_SSIM
    defaults): the contrast term at each scale, the full SSIM at the
    coarsest, a 2× average pool between scales.  Scales at which the image
    is under 11 px are dropped and the weights renormalised, as the JAX
    package does."""
    kernel = _gaussian_kernel(device=a.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def cs_and_ssim(x, y):
        mu_x, mu_y = _blur(x, kernel), _blur(y, kernel)
        var_x = _blur(x * x, kernel) - mu_x ** 2
        var_y = _blur(y * y, kernel) - mu_y ** 2
        cov = _blur(x * y, kernel) - mu_x * mu_y
        cs = torch.clamp_min((2 * cov + c2) / (var_x + var_y + c2),
                             0.0).mean()
        s = torch.clamp_min(
            (2 * mu_x * mu_y + c1) * (2 * cov + c2)
            / ((mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)),
            0.0).mean()
        return cs, s

    def pool(x):
        n, h, w, c = x.shape
        return x[:, :h // 2 * 2, :w // 2 * 2].reshape(
            n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))

    n_levels = 1
    size = min(a.shape[1], a.shape[2])
    while n_levels < len(weights) and size // 2 >= 11:
        n_levels += 1
        size //= 2
    used = np.asarray(weights[:n_levels], np.float64)
    used = used / used.sum()

    vals = []
    x, y = a, b
    for level in range(n_levels):
        cs, s = cs_and_ssim(x, y)
        vals.append(s if level == n_levels - 1 else cs)
        if level < n_levels - 1:
            x, y = pool(x), pool(y)
    out = torch.ones((), dtype=a.dtype, device=a.device)
    for v, w in zip(vals, used):
        out = out * torch.pow(torch.clamp_min(v, 1e-6), float(np.float32(w)))
    return out


def gradient_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Finite-difference gradient matching over [N, H, W, C] (reference
    models/loss.py:154-173, unused by its runners): the mean |Δpred - Δgt|
    of the two-pixel differences along W and along H, averaged."""
    h_p = pred[:, :, :-2, :] - pred[:, :, 2:, :]
    h_g = gt[:, :, :-2, :] - gt[:, :, 2:, :]
    v_p = pred[:, :-2, :, :] - pred[:, 2:, :, :]
    v_g = gt[:, :-2, :, :] - gt[:, 2:, :, :]
    return ((h_p - h_g).abs().mean() + (v_p - v_g).abs().mean()) / 2.0


def psnr_loss(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return -mse_to_psnr(l2(gt, pred))


def ssim_loss(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return 1.0 - ssim(gt, pred)


def msssim_loss(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return 1.0 - ms_ssim(gt, pred)


# ---------------------------------------------------------------------------
# segment helpers
# ---------------------------------------------------------------------------


def _segment_mean(values, seg, num_classes: int, weight):
    """Per-class weighted mean of [P, C] values with [P] int ids.
    Returns (means [num_classes, C], counts [num_classes, 1])."""
    w = weight.reshape(-1, 1)
    v = values.reshape(w.shape[0], -1)
    idx = seg.reshape(-1).to(torch.int64)
    sums = v.new_zeros((num_classes, v.shape[-1])).index_add(0, idx, v * w)
    counts = w.new_zeros((num_classes, 1)).index_add(0, idx, w)
    return sums / (counts + TINY_NUMBER), counts


def masked_quantile_per_class(values, seg, mask, num_classes: int, q):
    """Per-class q-quantile of `values` over the mask>0 pixels (linear
    interpolation, torch.quantile's rule), for all classes with one
    (class, value) lexsort of two stable argsorts — the JAX package's order,
    ties included.

    Args:
        values: [P]; seg: [P] int class ids; mask: [P] 0/1;
        q: [num_classes] quantile levels.
    Returns:
        (quantiles [num_classes], 0 where a class has no selected pixel;
         counts [num_classes]).
    """
    p = values.shape[0]
    seg = seg.reshape(-1).to(torch.int64)
    valid = mask > 0
    # unselected entries get a huge key and sort to the back of their class
    key = torch.where(valid, values, torch.full_like(values, 3.4e38))
    idx1 = torch.argsort(key, stable=True)
    idx2 = torch.argsort(seg[idx1], stable=True)
    sorted_vals = key[idx1[idx2]]          # grouped by class, ascending

    zeros = values.new_zeros(num_classes)
    counts = zeros.index_add(0, seg, valid.to(values.dtype))
    members = zeros.index_add(0, seg, torch.ones_like(values))
    starts = torch.cumsum(members, 0) - members

    top = torch.clamp_min(counts - 1.0, 0.0)
    pos = q * top
    lo = torch.floor(pos)
    frac = pos - lo
    idx_lo = (starts + lo).to(torch.int64).clamp(0, p - 1)
    idx_hi = (starts + torch.minimum(lo + 1, top)).to(torch.int64).clamp(0, p - 1)
    quant = sorted_vals[idx_lo] * (1 - frac) + sorted_vals[idx_hi] * frac
    return torch.where(counts > 0, quant, torch.zeros_like(quant)), counts


# ---------------------------------------------------------------------------
# SegLoss, TV, erosion
# ---------------------------------------------------------------------------


def seg_loss(
    img: torch.Tensor,
    seg_id: torch.Tensor,
    num_classes: int,
    mode: int,
    img_womipmap: Optional[torch.Tensor] = None,
    highlight: Optional[torch.Tensor] = None,
    valid_mask: Optional[torch.Tensor] = None,
    room_id: Optional[torch.Tensor] = None,
    num_rooms: int = 1,
    quantile_delta: float = 0.4,
    override_class: int = 43,
    override_value: float = 0.8,
) -> torch.Tensor:
    """Segmentation-prior smoothness loss (reference models/loss.py:214-295).

    mode 0 (albedo init): L1 pull of each pixel toward its class mean,
        averaged over num_classes × pixels × channels (the reference's L1
        over its [classes, pixels, C] expansion).
    mode 1 (roughness propagation): per class, the target is the
        δ-quantile of the no-mipmap roughness inside the class's highlight
        region (detached); class `override_class` gets a fixed target;
        classes without highlight get weight 0; the residual is taken on
        seg∖highlight.
    mode 2 (joint): class means per (room × class).

    Args:
        img: [F, H, W, C]; seg_id: [F, H, W] int class ids;
        img_womipmap / highlight: mode 1 ([F, H, W, C], [F, H, W, 1]);
        valid_mask: [F, H, W, 1] raster coverage (mode 1);
        room_id: [F, H, W] int room ids (mode 2).
    """
    f, h, w, c = img.shape
    pix = f * h * w
    flat = img.reshape(pix, c)
    seg = seg_id.reshape(pix).to(torch.int64)
    denom = num_classes * pix * c

    if mode == 0:
        means, _ = _segment_mean(flat, seg, num_classes, flat.new_ones(pix))
        return (flat - means[seg]).abs().sum() / denom

    if mode == 1:
        if img_womipmap is None or highlight is None:
            raise ValueError("seg_loss mode 1 needs img_womipmap and highlight")
        hl = (highlight.reshape(pix) > 0).to(flat.dtype)
        hi = hl
        if valid_mask is not None:
            hi = hi * (valid_mask.reshape(pix) > 0).to(flat.dtype)
        qs = flat.new_full((num_classes,), quantile_delta)
        target, counts = masked_quantile_per_class(
            img_womipmap.detach().reshape(pix, c)[:, 0], seg, hi,
            num_classes, qs,
        )
        if override_class < num_classes:  # JAX drops an out-of-range set
            fixed = torch.where(counts[override_class] > 0,
                                torch.full_like(target[0], override_value),
                                torch.zeros_like(target[0]))
            is_override = (torch.arange(num_classes, device=seg.device)
                           == override_class)
            target = torch.where(is_override, fixed, target)
        # residual on seg-minus-highlight pixels, weighted by the class's
        # highlight occupancy num/(num+ε) (≈1 when it has highlights)
        occupancy = counts / (counts + TINY_NUMBER)
        wgt = (1.0 - hl) * occupancy[seg]
        per_pixel = (flat[:, 0] - target[seg]).abs() * wgt
        return per_pixel.sum() * c / denom

    if mode == 2:
        if room_id is None:
            raise ValueError("seg_loss mode 2 needs room_id")
        joint = room_id.reshape(pix).to(torch.int64) * num_classes + seg
        means, _ = _segment_mean(flat, joint, num_rooms * num_classes,
                                 flat.new_ones(pix))
        return (flat - means[joint]).abs().sum() / (num_rooms * denom)

    raise ValueError(f"unknown seg_loss mode: {mode}")


def _erode(mask: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Min-pool erosion over the last two axes (the reference's
    -maxpool(-x)); outside the image counts as +inf."""
    shp = mask.shape
    x = mask.reshape((-1, 1) + tuple(shp[-2:]))
    out = -F.max_pool2d(-x, k, stride=1, padding=k // 2)
    return out.reshape(shp)


def tv_loss(img: torch.Tensor, seg_id: torch.Tensor, num_classes: int,
            weight: float = 0.01) -> torch.Tensor:
    """Eroded-seg-masked total variation (reference models/loss.py:176-212):
    differences count only where the pixel's 5×5 neighbourhood is one
    class, and never within 2 pixels of the image border.

    Args:
        img: [F, H, W, C]; seg_id: [F, H, W] int.
    """
    f, h, w, c = img.shape
    s = seg_id.to(torch.float32)
    smax = F.max_pool2d(s[:, None], 5, stride=1, padding=2)[:, 0]
    smin = -F.max_pool2d(-s[:, None], 5, stride=1, padding=2)[:, 0]
    same = (smax == smin).to(img.dtype)[..., None]
    border = img.new_zeros((h, w))
    border[2:-2, 2:-2] = 1.0
    same = same * border[None, :, :, None]
    dh = (img[:, 1:] - img[:, :-1]) * same[:, :-1]
    dw = (img[:, :, 1:] - img[:, :, :-1]) * same[:, :, :-1]
    count_h = c * (h - 1) * w
    count_w = c * h * (w - 1)
    return (
        weight * 2.0 * ((dh ** 2).sum() / count_h + (dw ** 2).sum() / count_w)
        / f / num_classes
    )


# ---------------------------------------------------------------------------
# RenderLoss (the Mat-stage objective)
# ---------------------------------------------------------------------------


def render_loss(
    gt_img: torch.Tensor,
    preds: Dict[str, torch.Tensor],
    gt_mask: torch.Tensor,
    seg_id: torch.Tensor,
    num_classes: int,
    stage: int,
    highlight: Optional[torch.Tensor] = None,
    seg_region: Optional[torch.Tensor] = None,
    room_id: Optional[torch.Tensor] = None,
    num_rooms: int = 1,
    loss_type: str = "L1",
    seg_weight_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stagewise Mat objective (reference models/loss.py:81-115).

    stage 0: L1(log) over gt_mask + 20·SegLoss(albedo, mode 0)
    stage 1: L1(log) over highlight∩seg region, scaled by h·w/classes
             + SegLoss(roughness, mode 1)
    stage 2: L1(log) over the seg region / classes
             + 0.2·SegLoss(roughness, mode 2)

    seg_weight_scale multiplies the stage-1/2 roughness prior terms only.
    Returns (total loss, seg term), both scalars.
    """
    fn = l1 if loss_type == "L1" else l2
    empty = preds["empty_mask"]
    pred_img = preds["rgb"] * empty
    f, h, w, _ = pred_img.shape

    if stage == 0:
        direct = fn(hdr_scale(pred_img * gt_mask), hdr_scale(gt_img * gt_mask))
        seg = seg_loss(preds["albedo"], seg_id, num_classes, mode=0) * 20.0
        return direct + seg, seg
    if stage == 1:
        if highlight is None or seg_region is None:
            raise ValueError("render_loss stage 1 needs highlight and seg_region")
        m = highlight * seg_region
        direct = fn(hdr_scale(gt_img * m), hdr_scale(pred_img * m)) * (
            h * w / num_classes
        )
        seg = seg_loss(
            preds["roughness"], seg_id, num_classes, mode=1,
            img_womipmap=preds["roughness_womipmap"], highlight=highlight,
        ) * seg_weight_scale
        return direct + seg, seg
    if stage == 2:
        if seg_region is None:
            raise ValueError("render_loss stage 2 needs seg_region")
        direct = fn(
            hdr_scale(gt_img * seg_region), hdr_scale(pred_img * seg_region)
        ) / num_classes
        seg = seg_loss(
            preds["roughness"], seg_id, num_classes, mode=2,
            room_id=room_id if room_id is not None else torch.zeros_like(seg_id),
            num_rooms=num_rooms, valid_mask=empty,
        ) * 0.2 * seg_weight_scale
        return direct + seg, seg
    raise ValueError(f"unknown render_loss stage: {stage}")


class RenderLoss:
    """`render_loss` behind the reference's class interface (models/
    loss.py:55-115)."""

    def __init__(self, loss_type: str = "L1", w_gradient: float = 0.0):
        self.loss_type = loss_type
        self.w_gradient = w_gradient

    def __call__(self, gt_img, preds, gt_mask, seg_id, num_classes, stage,
                 **kw):
        return render_loss(gt_img, preds, gt_mask, seg_id, num_classes,
                           stage, loss_type=self.loss_type, **kw)


# ---------------------------------------------------------------------------
# the baseline heads' losses
# ---------------------------------------------------------------------------


def kl_divergence(rho: float, latent: torch.Tensor) -> torch.Tensor:
    """Sparsity KL of sigmoid latents (reference models/loss.py:361-364):
    `latent` is the encoder's output before its sigmoid."""
    rho_hat = torch.clamp(torch.sigmoid(latent).mean(dim=0), 1e-6, 1 - 1e-6)
    return (rho * torch.log(rho / rho_hat)
            + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat))).mean()


def inv_loss(outputs: Dict[str, torch.Tensor], rgb_gt: torch.Tensor,
             latent_pre_sigmoid: torch.Tensor, sg_rgb_weight: float = 1.0,
             kl_weight: float = 0.01, latent_smooth_weight: float = 0.1,
             loss_type: str = "L1") -> Dict[str, torch.Tensor]:
    """InvRender objective (reference models/loss.py:297-396): the
    log-domain photometric loss, the KL sparsity of the latent and the
    smoothness of the jittered-latent decode."""
    fn = l1 if loss_type == "L1" else l2
    rgb_loss = fn(hdr_scale(outputs["rgb"]), hdr_scale(rgb_gt))
    smooth = (l1(outputs["diffuse_albedo"],
                 outputs["random_xi_diffuse_albedo"])
              + l1(outputs["roughness"][..., 0],
                   outputs["random_xi_roughness"][..., 0]))
    kl = kl_divergence(0.05, latent_pre_sigmoid)
    total = (sg_rgb_weight * rgb_loss + kl_weight * kl
             + latent_smooth_weight * smooth)
    return {"loss": total, "sg_rgb_loss": rgb_loss, "kl_loss": kl,
            "latent_smooth_loss": smooth}


def neilf_loss(outputs: Dict[str, torch.Tensor], rgb_gt: torch.Tensor,
               rgb_grad: torch.Tensor, lambertian_weighting: float = 0.0005,
               smoothness_weighting: float = 0.0005) -> torch.Tensor:
    """NeILF objective (reference models/loss.py:400-437): the log-domain
    photometric L1, the roughness-gradient smoothness gated by the image
    gradient, and the lambertian prior.  The 1e-12 inside the square root
    keeps the norm's gradient finite at a zero gradient (the zero-initialised
    BRDF MLP's)."""
    rgb_loss = l1(hdr_scale(outputs["rgb"]), hdr_scale(rgb_gt))
    norm = torch.sqrt((outputs["brdf_grad"] ** 2).sum(dim=-1) + 1e-12)
    smooth = (norm * torch.exp(-rgb_grad[..., 0])).mean()
    reg = (outputs["roughness"] - 1.0).abs().mean()
    return (rgb_loss + smoothness_weighting * smooth
            + lambertian_weighting * reg)


def nvdiffrec_loss(outputs: Dict[str, torch.Tensor], rgb_gt: torch.Tensor,
                   iteration, albedo_smooth_weight: float = 0.03
                   ) -> torch.Tensor:
    """nvdiffrec objective (reference models/loss.py:440-466): the
    log-domain MSE and the kd-gradient smoothness, ramped in over the
    first 100 iterations (min(1, it / 100))."""
    img_loss = l2(hdr_scale(outputs["rgb"]), hdr_scale(rgb_gt))
    ramp = min(1.0, float(iteration) / 100.0)
    return img_loss + outputs["kd_grad"].mean() * albedo_smooth_weight * ramp


InvLoss = inv_loss
NeILFLoss = neilf_loss
NvDiffRecLoss = nvdiffrec_loss
