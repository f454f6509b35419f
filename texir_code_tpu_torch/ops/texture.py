"""Differentiable texture sampling: bilinear, grid_sample, mip pyramids.

The port of the JAX package's `ops/texture.py`, the replacement for the two
samplers the reference leans on:

  * nvdiffrast ``dr.texture(..., 'linear-mipmap-linear')`` — the
    differentiable path into the material and IrT atlases (reference
    models/mat_nvdiffrast.py:128-139): ``build_mip_pyramid`` +
    ``compute_lod`` + ``texture_sample``, in exact trilinear,
    stochastic-LOD and stochastic-bilinear modes;
  * ``F.grid_sample(..., padding_mode='border', align_corners=False)`` —
    the cube↔pano warps: ``grid_sample``, with the JAX package's rounding
    of nearest taps (floor(x + 0.5)).

Gradients come from autograd: each texel fetch is a gather whose backward
is a scatter-add (`index_put_` with accumulate) into the flat pyramid, and
the pyramid's 2×2 means carry them back to the base atlas.  The JAX
package's sorted segment-sum backward (`take_segsum`) is off by default
there and is not ported.

Texture layout: ``tex[row, col, channel]``; uv=(u, v) maps to
``col = u·W - 0.5``, ``row = v·H - 0.5`` (v=0 is row 0).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def _gather2d(tex: torch.Tensor, row: torch.Tensor, col: torch.Tensor):
    """tex[row, col] for integer index tensors of any shape → [..., C]."""
    h, w = tex.shape[0], tex.shape[1]
    flat = tex.reshape(h * w, -1)
    idx = row * w + col
    return flat[idx.reshape(-1)].reshape(idx.shape + (tex.shape[-1],))


def bilinear_sample(
    tex: torch.Tensor, uv: torch.Tensor, boundary: str = "wrap"
) -> torch.Tensor:
    """Bilinear texture fetch at uv ∈ [0,1]² (nvdiffrast convention).

    Args:
        tex: [H, W, C].
        uv: [..., 2] with uv[..., 0]=u (width), uv[..., 1]=v (height).
        boundary: 'wrap' (nvdiffrast default), 'clamp' (border), or 'zero'.
    Returns:
        [..., C]
    """
    h, w = tex.shape[0], tex.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    weight = None
    if boundary == "wrap":
        xs = (torch.remainder(x0i, w), torch.remainder(x0i + 1, w))
        ys = (torch.remainder(y0i, h), torch.remainder(y0i + 1, h))
    elif boundary in ("clamp", "zero"):
        xs = (x0i.clamp(0, w - 1), (x0i + 1).clamp(0, w - 1))
        ys = (y0i.clamp(0, h - 1), (y0i + 1).clamp(0, h - 1))
        if boundary == "zero":
            def inb(i, n):
                return (i >= 0) & (i < n)

            weight = ((inb(x0i, w), inb(x0i + 1, w)),
                      (inb(y0i, h), inb(y0i + 1, h)))
    else:
        raise ValueError(f"unknown boundary mode: {boundary!r}")

    t00 = _gather2d(tex, ys[0], xs[0])
    t01 = _gather2d(tex, ys[0], xs[1])
    t10 = _gather2d(tex, ys[1], xs[0])
    t11 = _gather2d(tex, ys[1], xs[1])
    if weight is not None:
        (wx0, wx1), (wy0, wy1) = weight
        t00 = t00 * (wx0 & wy0)[..., None]
        t01 = t01 * (wx1 & wy0)[..., None]
        t10 = t10 * (wx0 & wy1)[..., None]
        t11 = t11 * (wx1 & wy1)[..., None]
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def grid_sample(
    tex: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "border",
) -> torch.Tensor:
    """torch.nn.functional.grid_sample semantics (align_corners=False) on
    an [H, W, C] texture, as the JAX package computes them.

    Args:
        grid: [..., 2]; grid[..., 0]=x ∈ [-1,1] (width), grid[..., 1]=y.
        mode: 'bilinear' or 'nearest' (rounds floor(x + 0.5): halves up).
        padding_mode: 'border' or 'zeros'.
    Returns:
        [..., C]
    """
    h, w = tex.shape[0], tex.shape[1]
    x = ((grid[..., 0] + 1.0) * w - 1.0) * 0.5
    y = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    if mode == "nearest":
        xi = torch.floor(x + 0.5).to(torch.int64)
        yi = torch.floor(y + 0.5).to(torch.int64)
        out = _gather2d(tex, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
        if padding_mode == "border":
            return out
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return out * inb[..., None]
    uv = torch.stack([(x + 0.5) / w, (y + 0.5) / h], dim=-1)
    return bilinear_sample(
        tex, uv, boundary="clamp" if padding_mode == "border" else "zero"
    )


def build_mip_pyramid(
    tex: torch.Tensor, max_levels: Optional[int] = None
) -> List[torch.Tensor]:
    """Box-filtered mip chain [base, base/2, ...]; each level is the 2×2
    mean of the previous, so gradients flow back to the base.  Stops when a
    dimension becomes odd or 1, or after max_levels levels."""
    levels = [tex]
    while True:
        cur = levels[-1]
        h, w = cur.shape[0], cur.shape[1]
        if h < 2 or w < 2 or h % 2 or w % 2:
            break
        if max_levels is not None and len(levels) >= max_levels + 1:
            break
        levels.append(cur.reshape(h // 2, 2, w // 2, 2, -1).mean(dim=(1, 3)))
    return levels


def compute_lod(uv_img: torch.Tensor, tex_h: int, tex_w: int) -> torch.Tensor:
    """Per-pixel mip LOD from image-space finite differences of uv.

    The ray-cast counterpart of nvdiffrast's analytic uv derivatives: the
    neighbouring-pixel uv difference; edge pixels replicate their
    neighbour's.

    Args:
        uv_img: [..., H, W, 2] uv per pixel.
    Returns:
        [..., H, W] LOD = log2(max texel footprint), clamped at 0.
    """
    du_x = torch.diff(uv_img, dim=-2, append=uv_img[..., :, -1:, :])
    du_x = torch.cat([du_x[..., :, :-1, :], du_x[..., :, -2:-1, :]], dim=-2)
    du_y = torch.diff(uv_img, dim=-3, append=uv_img[..., -1:, :, :])
    du_y = torch.cat([du_y[..., :-1, :, :], du_y[..., -2:-1, :, :]], dim=-3)

    def footprint_len(du):
        return torch.sqrt((du[..., 0] * tex_w) ** 2 + (du[..., 1] * tex_h) ** 2)

    fx = footprint_len(du_x)
    fy = footprint_len(du_y)
    footprint = torch.clamp_min(torch.maximum(fx, fy), 1e-12)
    return torch.clamp_min(torch.log2(footprint), 0.0)


def _flat_pyramid_fetch(
    flat: torch.Tensor,
    offsets: torch.Tensor,
    widths: torch.Tensor,
    heights: torch.Tensor,
    level: torch.Tensor,
    uv: torch.Tensor,
    boundary: str,
    rng_xy: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bilinear fetch at a per-sample mip level from the concatenated
    pyramid [total, C]: 4 gathers per sample whatever the depth.

    rng_xy: optional [..., 2] uniforms — stochastic bilinear: fetch ONE
    corner (x1 with probability fx, y1 with probability fy), an unbiased
    estimate of the bilinear value with a quarter of the gathers and of
    the backward's scatter-adds."""
    wi = widths[level]
    hi_ = heights[level]
    off = offsets[level]
    w = wi.to(uv.dtype)
    h = hi_.to(uv.dtype)

    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    if boundary == "wrap":
        xs = (torch.remainder(x0i, wi), torch.remainder(x0i + 1, wi))
        ys = (torch.remainder(y0i, hi_), torch.remainder(y0i + 1, hi_))
    else:
        xs = (torch.minimum(x0i.clamp_min(0), wi - 1),
              torch.minimum((x0i + 1).clamp_min(0), wi - 1))
        ys = (torch.minimum(y0i.clamp_min(0), hi_ - 1),
              torch.minimum((y0i + 1).clamp_min(0), hi_ - 1))

    def fetch(yy, xx):
        idx = off + yy * wi + xx
        return flat[idx.reshape(-1)].reshape(idx.shape + (flat.shape[-1],))

    if rng_xy is not None:
        xi = torch.where(rng_xy[..., 0] < fx[..., 0], xs[1], xs[0])
        yi = torch.where(rng_xy[..., 1] < fy[..., 0], ys[1], ys[0])
        return fetch(yi, xi)

    t00 = fetch(ys[0], xs[0])
    t01 = fetch(ys[0], xs[1])
    t10 = fetch(ys[1], xs[0])
    t11 = fetch(ys[1], xs[1])
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def texture_sample(
    pyramid: Sequence[torch.Tensor],
    uv: torch.Tensor,
    lod: Optional[torch.Tensor] = None,
    boundary: str = "wrap",
    rng: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample a mip pyramid with trilinear (linear-mipmap-linear) filtering.

    Args:
        pyramid: levels from build_mip_pyramid.
        uv: [..., 2] in [0,1].
        lod: [...] mip level per sample; None → bilinear on the base level.
        rng: optional uniforms in [0,1) — stochastic mip sampling.  Shape
            [...]: ONE level per tap (hi with probability frac(lod)).
            Shape [..., 3]: that (col 0) plus stochastic bilinear (cols
            1-2).  Both are unbiased for the texture-parameter gradient;
            the gradient with respect to uv and lod is zero in these modes.
    Returns:
        [..., C]
    """
    if lod is None or len(pyramid) == 1:
        return bilinear_sample(pyramid[0], uv, boundary)

    n_levels = len(pyramid)
    h0, w0, c = pyramid[0].shape
    for k, p in enumerate(pyramid):
        if tuple(p.shape[:2]) != (h0 >> k, w0 >> k):
            raise ValueError("texture_sample expects a build_mip_pyramid chain")
    # the level table is made on the device (a host-to-device copy would
    # stall the host behind a busy card)
    k = torch.arange(n_levels, device=uv.device)
    widths = torch.full_like(k, w0) >> k
    heights = torch.full_like(k, h0) >> k
    sizes = widths * heights
    offsets = torch.cumsum(sizes, 0) - sizes
    flat = torch.cat([p.reshape(-1, c) for p in pyramid], dim=0)

    lod = torch.clamp(lod, 0.0, n_levels - 1.0)
    lo = torch.floor(lod).to(torch.int64)
    hi = torch.clamp_max(lo + 1, n_levels - 1)
    frac = (lod - lo.to(lod.dtype))[..., None]

    if rng is not None:
        rng_xy = None
        if rng.dim() == lod.dim() + 1 and rng.shape == lod.shape + (3,):
            rng, rng_xy = rng[..., 0], rng[..., 1:]
        elif rng.shape != lod.shape:
            raise ValueError(
                "texture_sample rng must have shape lod.shape (stochastic"
                f" LOD) or lod.shape+(3,) (+stochastic bilinear); got rng "
                f"{tuple(rng.shape)} for lod {tuple(lod.shape)}"
            )
        lvl = torch.where(rng >= frac[..., 0], lo, hi)
        return _flat_pyramid_fetch(
            flat, offsets, widths, heights, lvl, uv, boundary, rng_xy=rng_xy
        )

    out_lo = _flat_pyramid_fetch(flat, offsets, widths, heights, lo, uv,
                                 boundary)
    out_hi = _flat_pyramid_fetch(flat, offsets, widths, heights, hi, uv,
                                 boundary)
    return out_lo * (1.0 - frac) + out_hi * frac
