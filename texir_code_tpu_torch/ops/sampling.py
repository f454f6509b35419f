"""Hemisphere sampling: Hammersley sequences and ONB direction generation.

The port of the JAX package's `ops/sampling.py` (reference
utils/sample_util.py): the stratified 2D samples are the Hammersley set
with a single random toroidal shift per batch row, clamped to
[TINY, 1-TINY]; the hemisphere mapping treats the surface normal as the
"y-up" axis of the local frame with
``L = V·(sinφ sinθ) + n·cosθ - U·(cosφ sinθ)`` and ``φ = 2π·u2 - π``.

Random numbers.  JAX keys rows by folding the global texel id into a
threefry key.  Torch cannot reproduce threefry, so rows keyed by id draw
their uniforms from a counter-based integer hash of (seed, row id, stream):
a row's samples depend on nothing else, so results do not change with
batching.  Unkeyed draws take an explicit `torch.Generator`.  Parity tests
inject the reference's own uniforms through `samples=`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

TINY_NUMBER = 1e-6
TINY_TINY_NUMBER = 1e-14

Vec3s = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_M32 = 0xFFFFFFFF


def radical_inverse(i: torch.Tensor) -> torch.Tensor:
    """Base-2 radical inverse (van der Corput) by 32-bit reversal, float64.

    Integer tensors hold the uint32 values in int64."""
    bits = i.to(torch.int64) & _M32
    bits = ((bits << 16) & _M32) | (bits >> 16)
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF)):
        bits = ((bits & mask) << shift) | ((bits >> shift) & mask)
    return bits.to(torch.float64) * 2.3283064365386963e-10


def hammersley(n: int, device=None) -> torch.Tensor:
    """[n, 2] Hammersley set (i/n, radical_inverse(i)) as float32, computed
    on `device` (no host copy)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return torch.stack(
        [i.to(torch.float64) / float(n), radical_inverse(i)], dim=-1
    ).to(torch.float32)


def radical_inverse_np(i: np.ndarray) -> np.ndarray:
    """Base-2 radical inverse (van der Corput) by 32-bit reversal; numpy,
    float64."""
    bits = np.asarray(i, dtype=np.uint32)
    bits = (bits << np.uint32(16)) | (bits >> np.uint32(16))
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
                        (8, 0x00FF00FF)):
        s, m = np.uint32(shift), np.uint32(mask)
        bits = ((bits & m) << s) | ((bits >> s) & m)
    return bits.astype(np.float64) * 2.3283064365386963e-10


def hammersley_np(n: int) -> np.ndarray:
    """[n, 2] Hammersley set (i/n, radical_inverse(i)) as float32, on the
    host."""
    i = np.arange(n, dtype=np.uint32)
    return np.stack(
        [i.astype(np.float64) / float(n), radical_inverse_np(i)], axis=-1
    ).astype(np.float32)


def hammersley_azimuth_sorted(n: int, device=None) -> torch.Tensor:
    """The Hammersley set reordered by u2 (the azimuth coordinate), [n, 2]
    float32 on `device`.

    The same sample set as `hammersley`, so order-invariant estimators are
    unaffected, but consecutive chunks of it map to contiguous azimuth
    arcs of the hemisphere.  A row's toroidal shift rotates every arc by
    the same amount, so each chunk stays an arc of the same sample count:
    wedge rows with tight direction cones and no sort at run time (the
    baker's chunk_mode "azimuth")."""
    h = hammersley_np(n)
    order = np.argsort(h[:, 1], kind="stable")
    return torch.from_numpy(h[order]).to(device)


def _hash32(x):
    """32-bit integer mix (lowbias32) of a Python int, or of int64 tensors
    holding uint32s.  Products may wrap in int64; only their low 32 bits
    are kept."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def hash_uniform(seed: int, ids: torch.Tensor, stream: torch.Tensor):
    """Uniforms in [0, 1) as a pure function of (seed, id, stream).

    ids [B] and stream [...] broadcast to [B, ...]; float32, 24 bits."""
    ids = ids.to(torch.int64)
    key = _hash32(int(seed))  # a Python int: no host-to-device copy
    h = _hash32(_hash32(ids ^ key)[:, None] + stream.to(torch.int64)[None])
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def normalize(x: torch.Tensor, eps: float = TINY_NUMBER) -> torch.Tensor:
    """x / (||x|| + eps) along the last axis (reference's norm_axis)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def _soa_norm(v: Vec3s, eps: float = TINY_NUMBER) -> Vec3s:
    n = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]) + eps
    return (v[0] / n, v[1] / n, v[2] / n)


def _soa_cross(a: Vec3s, b: Vec3s) -> Vec3s:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def build_onb_soa(normals: Vec3s) -> Tuple[Vec3s, Vec3s, Vec3s]:
    """SoA orthonormal basis (n, U, V) about each normal.

    Matches reference utils/sample_util.py:84-91: helper axis is (0,1,0)
    where |n.x| > 0.99 else (1,0,0); U = normalize(cross(axis, n));
    V = normalize(cross(n, U))."""
    big = torch.abs(normals[0]) > 0.99
    one = torch.ones_like(normals[0])
    zero = torch.zeros_like(normals[0])
    ax: Vec3s = (
        torch.where(big, zero, one),
        torch.where(big, one, zero),
        zero,
    )
    n = _soa_norm(normals)
    u = _soa_norm(_soa_cross(ax, n))
    v = _soa_norm(_soa_cross(n, u))
    return n, u, v


def build_onb(normals: torch.Tensor):
    """AoS wrapper of build_onb_soa: [..., 3] in/out."""
    n, u, v = build_onb_soa(tuple(normals[..., k] for k in range(3)))
    return tuple(torch.stack(t, dim=-1) for t in (n, u, v))


def stratified_samples(
    batch: int,
    num_samples: int,
    pre_mode: str = "hammersley",
    row_ids: Optional[torch.Tensor] = None,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    base: Optional[torch.Tensor] = None,
    device=None,
) -> torch.Tensor:
    """[batch, num_samples, 2] 2D sample points in (0, 1).

    pre_mode 'hammersley': the Hammersley set with one random toroidal
    shift per batch row, clamped to [TINY, 1-TINY].  pre_mode
    'independent': iid uniforms.

    row_ids: optional [batch] global row ids.  When given, each row's
    randomness is a pure function of (seed, its id) — a bake is then
    identical however its texels are batched.  Otherwise the draws come
    from `generator` on `device`."""
    if row_ids is not None:
        device = row_ids.device
    if pre_mode.lower() == "hammersley":
        if base is None:
            base = hammersley(num_samples, device)
        base = base[None, :, :]  # [1, S, 2]
        if row_ids is not None:
            stream = torch.arange(2, device=device)
            shift = hash_uniform(seed, row_ids, stream)[:, None, :]
        else:
            shift = torch.rand(
                (batch, 1, 2), generator=generator
            ).to(device)
        samples = torch.remainder(base + shift, 1.0)
    elif pre_mode == "independent":
        if row_ids is not None:
            stream = torch.arange(2 * num_samples, device=device)
            samples = hash_uniform(seed, row_ids, stream).reshape(
                batch, num_samples, 2
            )
        else:
            samples = torch.rand(
                (batch, num_samples, 2), generator=generator
            ).to(device)
    else:
        raise ValueError(f"unknown pre_mode: {pre_mode!r}")
    return torch.clamp(samples, TINY_NUMBER, 1.0 - TINY_NUMBER)


def shifted_samples(num: int, shift: torch.Tensor) -> torch.Tensor:
    """[B, num, 2] Hammersley samples toroidally shifted by each row's
    [B, 2] uniforms and clamped to [TINY, 1 - TINY] (stratified_samples
    with its shifts given: a model's injected or hashed draws)."""
    base = hammersley(num, shift.device)[None]
    return torch.clamp(torch.remainder(base + shift[:, None, :], 1.0),
                       TINY_NUMBER, 1.0 - TINY_NUMBER)


def generate_dir_soa(
    normals: Vec3s,
    num_samples: int,
    mode: str = "uniform",
    roughness: Optional[torch.Tensor] = None,
    pre_mode: str = "hammersley",
    samples: Optional[torch.Tensor] = None,
    row_ids: Optional[torch.Tensor] = None,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
    base: Optional[torch.Tensor] = None,
) -> Vec3s:
    """Sample hemisphere directions, SoA: normals are 3×[B], output 3×[B, S].

    Args:
        normals: (nx, ny, nz) each [B].
        num_samples: sample count S.
        mode: 'uniform' (pdf 1/2π), 'cosine' (pdf cosθ/π), or 'importance'
            (GGX half-vector NDF importance sampling; requires `roughness`).
        roughness: [B] or [B, 1] for mode='importance'.
        pre_mode: 'hammersley' or 'independent'.
        samples: optional precomputed [B, S, 2] samples (overrides pre_mode).
        row_ids / seed / generator / base: see stratified_samples.

    Returns:
        (lx, ly, lz) each [B, S].  For 'importance' these are *half-vectors*
        to be reflected about the view direction, as the reference uses them.
    """
    b = normals[0].shape[0]
    n, u, v = build_onb_soa(normals)
    if samples is None:
        samples = stratified_samples(
            b, num_samples, pre_mode, row_ids=row_ids, seed=seed,
            generator=generator, base=base, device=normals[0].device,
        )
    u1 = samples[..., 0]  # [B, S]
    u2 = samples[..., 1]

    mode = mode.lower()
    if mode == "uniform":
        cos_theta = 1.0 - u1
    elif mode == "cosine":
        cos_theta = torch.sqrt(1.0 - u1)
    elif mode == "importance":
        if roughness is None:
            raise ValueError("mode='importance' requires roughness")
        r = roughness.reshape(b, 1)
        a = r * r
        cos_theta = torch.sqrt((1.0 - u1) / (1.0 + (a * a - 1.0) * u1))
        # clamp exactly as the reference does to keep the backward finite
        cos_theta = torch.clamp(
            cos_theta, -1.0 + TINY_NUMBER, 1.0 - TINY_NUMBER
        )
    else:
        raise ValueError(f"unknown sampling mode: {mode!r}")

    phi = 2.0 * math.pi * u2 - math.pi
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, 0.0, 1.0))
    sp = torch.sin(phi) * sin_theta
    cp = -(torch.cos(phi) * sin_theta)
    return tuple(
        v[k][:, None] * sp + n[k][:, None] * cos_theta + u[k][:, None] * cp
        for k in range(3)
    )


def generate_dir(
    normals: torch.Tensor,
    num_samples: int,
    mode: str = "uniform",
    roughness: Optional[torch.Tensor] = None,
    pre_mode: str = "hammersley",
    samples: Optional[torch.Tensor] = None,
    row_ids: Optional[torch.Tensor] = None,
    seed: int = 0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """AoS wrapper of generate_dir_soa: normals [B, 3] → dirs [B, S, 3]."""
    soa = generate_dir_soa(
        tuple(normals[..., k] for k in range(3)), num_samples, mode=mode,
        roughness=roughness, pre_mode=pre_mode, samples=samples,
        row_ids=row_ids, seed=seed, generator=generator,
    )
    return torch.stack(soa, dim=-1)


def reflect_soa(view: Vec3s, half: Vec3s):
    """SoA reflect: view 3×[B], half 3×[B, S] → (light 3×[B, S], vdh [B, S]).

    Matches reference models/mat_nvdiffrast.py:235-236:
    ``l = 2·(v·h)·h - v`` with v·h clamped to [0, 1]."""
    vdh = (
        half[0] * view[0][:, None]
        + half[1] * view[1][:, None]
        + half[2] * view[2][:, None]
    ).clamp(0.0, 1.0)
    light = tuple(2.0 * vdh * half[k] - view[k][:, None] for k in range(3))
    return light, vdh


def reflect(view: torch.Tensor, half: torch.Tensor):
    """Reflect view directions about sampled half-vectors, AoS: view
    [B, 3], half [B, S, 3] → (light_dirs [B, S, 3], vdh [B, S, 1]), with
    ``l = 2·(v·h)·h - v`` and v·h clamped to [0, 1]."""
    vdh = (half * view[:, None, :]).sum(dim=-1, keepdim=True).clamp(0.0, 1.0)
    return 2.0 * vdh * half - view[:, None, :], vdh
