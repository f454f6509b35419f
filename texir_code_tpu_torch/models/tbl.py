"""TBL — Texture-Based Lighting: the scene's own HDR atlas as the emitter.

Incident radiance along a ray is the HDR texture of the mesh at the ray's
hit point.  The port of the JAX package's `models/tbl.py` on its culled
path: the per-corner uvs, the atlas planes, the RGBE-packed atlas fetches
(exact bilinear, and the 2×-supersampled prefiltered atlas read with one
nearest fetch), `radiance_from_hit`, and the bulk ray query
`query_tbl_stream` / `query_tbl_auto`, whose rays go through the culled
cluster walk (kernel B1 on the card, its plain version on the CPU).  The
JAX package's BVH traversal and exhaustive leaf streams (kernels B2/B3)
serve only scenes without a ClusterScene and are not ported: this TBL
holds no BVH.

Conventions of the reference: hits with t ≤ 1e-4 (or misses) give zero
radiance; barycentric uv is clipped to [0, 1]; the atlas is fetched with
clamp-boundary bilinear filtering and stored v-up.

Layout: SoA — per-corner uvs as separate [F*3] u/v tensors, the atlas as
three [H, W] channel planes.  RGBE words are int32 tensors holding the bit
patterns of the JAX package's uint32 words.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.ops.shading import rgb_to_intensity


@dataclasses.dataclass
class TBL:
    """Texture-based-lighting scene.

    Attributes:
        uv_u, uv_v: [F*3] per-corner uv components (indexed prim*3+k).
        planes: three [H, W] HDR atlas channel planes, exposure-scaled, v-up.
    """

    uv_u: torch.Tensor
    uv_v: torch.Tensor
    planes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

    @property
    def texture(self) -> torch.Tensor:
        """[H, W, 3] view of the atlas."""
        return torch.stack(self.planes, dim=-1)

    def with_texture(self, texture: torch.Tensor) -> "TBL":
        """The same TBL with the atlas replaced ([H, W, 3])."""
        planes = tuple(texture[..., k].contiguous() for k in range(3))
        return TBL(self.uv_u, self.uv_v, planes)


def build_tbl(mesh, texture, hdr_exposure: float = 0.0, device="cuda") -> TBL:
    """Host-side constructor: mesh + HDR atlas → TBL.

    Args:
        mesh: geometry.Mesh with uvs.
        texture: [H, W, 3] float32 HDR atlas, v-up row order.
        hdr_exposure: multiplies the atlas by 2**hdr_exposure.
    """
    dev = resolve_device(device)
    tuv = mesh.triangle_uvs()
    tex = np.asarray(texture, np.float32) * (2.0 ** hdr_exposure)
    return TBL(
        uv_u=torch.from_numpy(np.ascontiguousarray(tuv[:, 0])).to(dev),
        uv_v=torch.from_numpy(np.ascontiguousarray(tuv[:, 1])).to(dev),
        planes=tuple(
            torch.from_numpy(np.ascontiguousarray(tex[..., k])).to(dev)
            for k in range(3)
        ),
    )


def build_tbl_from_flat(flat_bvh, mesh, texture, hdr_exposure: float = 0.0,
                        device="cuda") -> TBL:
    """TBL beside a pre-built FlatBVH, as the JAX package builds it.  The
    port's TBL holds no BVH (its rays go through a ClusterScene built from
    the same FlatBVH), so only the mesh and the atlas are read."""
    del flat_bvh
    return build_tbl(mesh, texture, hdr_exposure, device=device)


def vhl_texture(texture: torch.Tensor, hdr_exposure: float) -> torch.Tensor:
    """Virtual-highlight emitter: keep only light-source texels.

    The reference's stage -1 trick (models/mat_nvdiffrast.py:142-145):
    texels whose unexposed intensity is ≥ 0.5 keep their radiance, all
    others go black, so a render with this emitter localizes highlights."""
    intensity = rgb_to_intensity(texture * (2.0 ** -hdr_exposure))
    return torch.where(intensity >= 0.5, texture, torch.zeros_like(texture))


def rgbe_pack(texture: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] float radiance → [H, W] int32 RGBE (shared exponent;
    the bit pattern of the reference's uint32 word)."""
    m = texture.amax(dim=-1)
    maxc = torch.clamp_min(m, 1e-32)
    exp = torch.ceil(torch.log2(maxc)).to(torch.int32)
    scale = torch.exp2(-exp.to(torch.float32)) * 255.0
    q = torch.clamp(
        (texture * scale[..., None]).to(torch.int32), 0, 255
    ).to(torch.int64)
    e = torch.clamp(exp + 128, 0, 255).to(torch.int64)
    packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (e << 24)
    packed = torch.where(m > 1e-30, packed, torch.zeros_like(packed))
    # uint32 → int32 bit pattern (two's complement wrap)
    return (packed - ((packed >> 31) << 32)).to(torch.int32)


def rgbe_decode(packed: torch.Tensor):
    """int32 RGBE words → (r, g, b) float planes."""
    e = (packed >> 24) & 0xFF
    scale = torch.where(
        packed == 0,
        torch.zeros((), device=packed.device),
        torch.exp2(e.to(torch.float32) - 128.0) / 255.0,
    )
    r = (packed & 0xFF).to(torch.float32) * scale
    g = ((packed >> 8) & 0xFF).to(torch.float32) * scale
    b = ((packed >> 16) & 0xFF).to(torch.float32) * scale
    return r, g, b


def _bilinear_index(h: int, w: int, u: torch.Tensor, v: torch.Tensor):
    """Corner indices and weights of a clamp-boundary bilinear fetch."""
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x0i = torch.clamp(x0i, 0, w - 1)
    y0i = torch.clamp(y0i, 0, h - 1)
    idx = (y0i * w + x0i, y0i * w + x1i, y1i * w + x0i, y1i * w + x1i)
    return idx, fx, fy


def bilinear_rgbe(packed: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear HDR fetch from an RGBE-packed [H, W] atlas (4 word
    gathers), clamp boundary."""
    h, w = packed.shape
    (i00, i01, i10, i11), fx, fy = _bilinear_index(h, w, u, v)
    flat = packed.reshape(-1)
    c00 = rgbe_decode(flat[i00])
    c01 = rgbe_decode(flat[i01])
    c10 = rgbe_decode(flat[i10])
    c11 = rgbe_decode(flat[i11])
    outs = []
    for k in range(3):
        top = c00[k] * (1 - fx) + c01[k] * fx
        bot = c10[k] * (1 - fx) + c11[k] * fx
        outs.append(top * (1 - fy) + bot * fy)
    return tuple(outs)


def _bilinear_planes(planes, u: torch.Tensor, v: torch.Tensor):
    """Bilinear fetch of channel planes at uv (clamp boundary), SoA."""
    h, w = planes[0].shape
    (i00, i01, i10, i11), fx, fy = _bilinear_index(h, w, u, v)
    outs = []
    for p in planes:
        flat = p.reshape(-1)
        top = flat[i00] * (1 - fx) + flat[i01] * fx
        bot = flat[i10] * (1 - fx) + flat[i11] * fx
        outs.append(top * (1 - fy) + bot * fy)
    return tuple(outs)


def rgbe_prefilter(planes, factor: int = 2) -> torch.Tensor:
    """Prefiltered RGBE atlas: [f·H, f·W] words whose entry (i, j) is the
    exact bilinear value of `planes` at the supersample center
    ((j+0.5)/fW, (i+0.5)/fH) — a nearest fetch from it equals a bilinear
    fetch snapped to the nearest half-texel.

    Args:
        planes: 3-tuple of [H, W] float planes (TBL.planes layout).
    """
    h, w = planes[0].shape
    fh, fw = factor * h, factor * w
    dev = planes[0].device
    u = (torch.arange(fw, dtype=torch.float32, device=dev) + 0.5) / fw
    v = (torch.arange(fh, dtype=torch.float32, device=dev) + 0.5) / fh
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    vals = _bilinear_planes(tuple(planes), uu.reshape(-1), vv.reshape(-1))
    tex = torch.stack([x.reshape(fh, fw) for x in vals], dim=-1)
    return rgbe_pack(tex)


def nearest_rgbe(packed: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Nearest HDR fetch from an RGBE atlas (1 word gather).  On a
    rgbe_prefilter-ed atlas this is a half-texel-snapped bilinear fetch."""
    h, w = packed.shape
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return rgbe_decode(packed.reshape(-1)[y * w + x])


def radiance_from_hit(tbl: TBL, hit, t_valid: float = 1e-4):
    """Hit record → emitted radiance: per-corner uv lerp + bilinear atlas
    fetch, zero for misses and sub-epsilon hits (reference :299-318)."""
    valid = torch.isfinite(hit.t) & (hit.t > t_valid)
    prim = torch.where(valid, hit.prim, 0).to(torch.int64)
    u = hit.u.clamp(0.0, 1.0)
    v = hit.v.clamp(0.0, 1.0)
    w0 = 1.0 - u - v
    base = prim * 3
    uu = tbl.uv_u[base] * w0 + tbl.uv_u[base + 1] * u + tbl.uv_u[base + 2] * v
    vv = tbl.uv_v[base] * w0 + tbl.uv_v[base + 1] * u + tbl.uv_v[base + 2] * v
    rgb = _bilinear_planes(tbl.planes, uu, vv)
    return tuple(torch.where(valid, c, torch.zeros_like(c)) for c in rgb)


def _row_split(n: int, max_r: int = 2048) -> int:
    """Largest multiple-of-128 row width dividing n (n % 128 == 0)."""
    r = min(max_r, n)
    r -= r % 128
    while r > 128 and n % r:
        r -= 128
    return r


def query_tbl_stream(
    tbl: TBL,
    origins,
    dirs,
    cluster_scene,
    t_valid: float = 1e-4,
    rgbe_pre: Optional[torch.Tensor] = None,
    fan_block: int = 8,
    exit_rows: int = 0,
    row_width: int = 2048,
    occluders=None,
):
    """Incident radiance along bulk per-ray-origin rays (the fused
    `query_irf`), traced by the culled walk with per-ray origins.

    Args:
        origins / dirs: 3-tuples of same-shape tensors whose size is a
            multiple of 128; rows of row_width raster-consecutive rays keep
            the per-row origin boxes (and so the candidate lists) tight.
        cluster_scene: ops.pallas_culled.ClusterScene of the emitter mesh.
        rgbe_pre: optional rgbe_prefilter-ed atlas.  With it (and uv rows
            in the cluster scene) the walk interpolates the hit's atlas uv
            and radiance is one nearest RGBE fetch per ray; without it the
            walk returns prim + barycentrics for radiance_from_hit.
    Returns:
        (r, g, b) shaped like origins[0]; zero for misses.  Not
        differentiable — lighting is detached in the reference too.
    """
    from texir_code_tpu_torch.ops.pallas_culled import cast_fans_culled

    shape = origins[0].shape
    total = int(np.prod(shape))
    r = _row_split(total, row_width)
    rows = total // r
    emit_uv = rgbe_pre is not None and cluster_scene.has_uv
    hit = cast_fans_culled(
        cluster_scene,
        tuple(o.reshape(rows, r) for o in origins),
        tuple(d.reshape(rows, r) for d in dirs),
        per_ray=True, fan_block=fan_block, exit_rows=exit_rows,
        emit_uv=emit_uv, occluders=occluders,
    )
    if emit_uv:
        valid = torch.isfinite(hit.t) & (hit.t > t_valid)
        rgb = nearest_rgbe(rgbe_pre, hit.u.clamp(0.0, 1.0),
                           hit.v.clamp(0.0, 1.0))
        out = tuple(torch.where(valid, c, torch.zeros_like(c)) for c in rgb)
    else:
        out = radiance_from_hit(tbl, hit, t_valid)
    return tuple(x.reshape(shape) for x in out)


def query_tbl_auto(tbl: TBL, origins, dirs, cluster_scene, **kw):
    """query_tbl_stream for rays of any count: pads them to a multiple of
    128 with zero directions (which hit nothing) and drops the padding.
    The device of the tensors picks the walk: the CUDA kernel on the
    card, its plain version on the CPU (ops.pallas_culled.culled_walk)."""
    shape = origins[0].shape
    total = int(np.prod(shape))
    pad = (-total) % 128
    if not pad:
        return query_tbl_stream(tbl, origins, dirs, cluster_scene, **kw)

    def flat(a):
        return torch.nn.functional.pad(a.reshape(-1), (0, pad))

    out = query_tbl_stream(tbl, tuple(map(flat, origins)),
                           tuple(map(flat, dirs)), cluster_scene, **kw)
    return tuple(x[:total].reshape(shape) for x in out)
