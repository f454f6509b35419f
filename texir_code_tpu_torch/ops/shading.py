"""Physically based shading: Cook-Torrance terms and Monte-Carlo estimators.

The port of the JAX package's `ops/shading.py` (reference
utils/general.py:61-112 and models/mat_nvdiffrast.py:232-279):

  * ``hdr_scale``, ``tonemap``, ``mse_to_psnr``, ``rgb_to_intensity``,
    ``get_mip_level`` — the HDR-domain helpers;
  * ``fresnel_schlick_ue4``, ``smith_g``, ``ggx_d`` — the BRDF terms;
  * ``lambertian_diffuse`` (the IrT path), ``irradiance_estimator_soa`` (the
    bake) and ``specular_estimator_soa`` (GGX importance MC).

Everything is elementwise fp32 PyTorch; the reference's epsilon clamps are
kept as they are — they keep backward passes finite at grazing angles.
"""

from __future__ import annotations

import math

import torch

from texir_code_tpu_torch.ops.sampling import TINY_TINY_NUMBER


def hdr_scale(img: torch.Tensor, base: float = math.e) -> torch.Tensor:
    """log-domain compression: log(1+x)/log(base)."""
    return torch.log(img + 1.0) / math.log(base)


def tonemap(img: torch.Tensor) -> torch.Tensor:
    """Gamma-2.2 tonemapping clamped to [0, 1]."""
    return torch.clamp(
        torch.pow(torch.clamp_min(img, 0.0), 1.0 / 2.2), 0.0, 1.0
    )


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR assuming peak value 1."""
    return -10.0 / math.log(10.0) * torch.log(mse)


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 luma over the last axis: [..., 3] -> [..., 1]."""
    return (
        0.29900 * rgb[..., 0:1] + 0.58700 * rgb[..., 1:2]
        + 0.11400 * rgb[..., 2:3]
    )


def get_mip_level(n: int) -> int:
    """Number of trailing zero bits (mip count of a power-of-two texture)."""
    count = 0
    while not (n & 1 or n == 1):
        n >>= 1
        count += 1
    return count


def fresnel_schlick_ue4(vdh: torch.Tensor, f0: float = 0.04) -> torch.Tensor:
    """Schlick Fresnel with the UE4 spherical-gaussian exponent:
    f = f0 + (1-f0) · 2^((-5.55472·vdh - 6.98316)·vdh)."""
    return f0 + (1.0 - f0) * torch.pow(2.0, (-5.55472 * vdh - 6.98316) * vdh)


def smith_g(ndv, ndl, roughness):
    """Smith geometry term with the UE4 direct-lighting k = (r+1)²/8:
    g1(x) = x / max(x·(1-k) + k, TINY_TINY)."""
    k = (roughness + 1.0) * (roughness + 1.0) / 8.0
    g1_ndv = ndv / torch.clamp_min(ndv * (1.0 - k) + k, TINY_TINY_NUMBER)
    g1_ndl = ndl / torch.clamp_min(ndl * (1.0 - k) + k, TINY_TINY_NUMBER)
    return g1_ndl * g1_ndv


def ggx_d(ndh, roughness):
    """GGX/Trowbridge-Reitz NDF with α = roughness²."""
    a2 = torch.square(torch.square(roughness))
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(math.pi * denom * denom, TINY_TINY_NUMBER)


def lambertian_diffuse(irradiance, albedo):
    """Diffuse shading from a pre-integrated irradiance (the IrT path):
    irr · albedo / π (reference models/mat_nvdiffrast.py:232)."""
    return irradiance * albedo / math.pi


def irradiance_estimator_soa(lighting, light_dirs, normal, num_samples: int):
    """SoA irradiance: lighting 3×[B, S], dirs 3×[B, S], normal 3×[B]
    → 3×[B] (reference models/tracer_o3d_irt.py:156-174: Σ L·ndl·2π/S)."""
    ndl = (
        normal[0][:, None] * light_dirs[0]
        + normal[1][:, None] * light_dirs[1]
        + normal[2][:, None] * light_dirs[2]
    ).clamp(0.0, 1.0)
    scale = 2.0 * math.pi / num_samples
    return tuple((lighting[k] * ndl).sum(dim=1) * scale for k in range(3))


def specular_estimator_soa(lighting, half, normal, view, light_dirs,
                           roughness):
    """SoA Cook-Torrance specular: lighting/half/light_dirs 3×[B, S],
    normal/view 3×[B], roughness [B] → 3×[B], not divided by S.

    With half-vectors drawn proportionally to D·ndh/(4·vdh) the estimator
    is Σ L · [F·G / max(4·ndl·ndv, ε)] · ndl · 4·vdh / max(ndh, ε): the D
    term cancels against the pdf (reference models/mat_nvdiffrast.py:
    260-279)."""

    def bdot(a_b, b_bs):
        return (
            a_b[0][:, None] * b_bs[0]
            + a_b[1][:, None] * b_bs[1]
            + a_b[2][:, None] * b_bs[2]
        ).clamp(0.0, 1.0)

    vdh = bdot(view, half)
    ndl = bdot(normal, light_dirs)
    ndh = bdot(normal, half)
    ndv = (
        normal[0] * view[0] + normal[1] * view[1] + normal[2] * view[2]
    ).clamp(0.0, 1.0)[:, None]

    f = fresnel_schlick_ue4(vdh)
    g = smith_g(ndv, ndl, roughness[:, None])
    brdf = f * g / torch.clamp_min(4.0 * ndl * ndv, TINY_TINY_NUMBER)
    weight = brdf * ndl * 4.0 * vdh / torch.clamp_min(ndh, TINY_TINY_NUMBER)
    return tuple((lighting[k] * weight).sum(dim=1) for k in range(3))
