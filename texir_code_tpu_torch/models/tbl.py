"""TBL — Texture-Based Lighting: the scene's own HDR atlas as the emitter.

Incident radiance along a ray is the HDR texture of the mesh at the ray's
hit point.  The port of the JAX package's `models/tbl.py`: the per-corner
uvs, the atlas planes and the scene's skip-link BVH; the RGBE-packed atlas
fetches (exact bilinear, and the 2×-supersampled prefiltered atlas read
with one nearest fetch); `radiance_from_hit`; the BVH queries
(`query_tbl_soa` and its AoS wrappers `query_tbl` / `query_tbl_multi`,
ops.raycast.cast_rays_soa in plain PyTorch), the leaf-budgeted fan query
`query_tbl_fans` (ops.fan_raycast.cast_ray_fans_exact); and the bulk ray
query `query_tbl_stream` / `query_tbl_auto`, whose rays go through the
culled cluster walk (kernel B1 on the card, its plain version on the CPU)
or, for a scene with only a FanScene, the exhaustive leaf stream (kernel
B3).  `query_tbl_auto` with neither scene traces with the BVH, as the JAX
package's does.

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

from texir_code_tpu_torch import profiling
from texir_code_tpu_torch.device import resolve_device
from texir_code_tpu_torch.ops.raycast import DeviceBVH, cast_rays_soa
from texir_code_tpu_torch.ops.shading import rgb_to_intensity


@dataclasses.dataclass
class TBL:
    """Texture-based-lighting scene.

    Attributes:
        uv_u, uv_v: [F*3] per-corner uv components (indexed prim*3+k).
        planes: three [H, W] HDR atlas channel planes, exposure-scaled, v-up.
        bvh: the emitter mesh's DeviceBVH, which the BVH queries trace
            (None: a TBL for the culled walk or the leaf stream only).
    """

    uv_u: torch.Tensor
    uv_v: torch.Tensor
    planes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    bvh: Optional[DeviceBVH] = None

    @property
    def texture(self) -> torch.Tensor:
        """[H, W, 3] view of the atlas."""
        return torch.stack(self.planes, dim=-1)

    def with_texture(self, texture: torch.Tensor) -> "TBL":
        """The same TBL with the atlas replaced ([H, W, 3])."""
        planes = tuple(texture[..., k].contiguous() for k in range(3))
        return TBL(self.uv_u, self.uv_v, planes, self.bvh)


@profiling.timed("pack", "tbl")
def build_tbl_from_flat(flat_bvh, mesh, texture, hdr_exposure: float = 0.0,
                        device="cuda") -> TBL:
    """TBL from a pre-built FlatBVH (one build shared by the TBL, the
    FanScene and the ClusterScene).

    Args:
        flat_bvh: geometry.bvh.FlatBVH of the mesh; its supernode table goes
            to the device as the TBL's BVH.
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
        bvh=DeviceBVH.from_flat(flat_bvh, device=dev),
    )


def build_tbl(mesh, texture, hdr_exposure: float = 0.0, device="cuda") -> TBL:
    """Host-side constructor: mesh + HDR atlas → TBL, building the mesh's
    BVH (geometry.bvh.build_bvh)."""
    from texir_code_tpu_torch.geometry.bvh import build_bvh

    flat = build_bvh(mesh.vertices, mesh.faces)
    return build_tbl_from_flat(flat, mesh, texture, hdr_exposure,
                               device=device)


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


def query_tbl_soa(tbl: TBL, points, dirs, t_valid: float = 1e-4):
    """Incident radiance along rays through the BVH, SoA (the fused
    `query_irf`).

    Args:
        points / dirs: 3-tuples of same-shape ray origins (pre-offset by
            ε·normal at call sites) and directions.
        t_valid: hits at t ≤ this give zero radiance.
    Returns:
        (r, g, b) shaped like points[0]; zero for misses.
    """
    if tbl.bvh is None:
        raise ValueError("query_tbl_soa needs a TBL with a BVH "
                         "(build_tbl / build_tbl_from_flat)")
    hit = cast_rays_soa(tbl.bvh, points, dirs, t_min=0.0)
    return radiance_from_hit(tbl, hit, t_valid)


def query_tbl(tbl: TBL, points: torch.Tensor, dirs: torch.Tensor,
              t_valid: float = 1e-4) -> torch.Tensor:
    """AoS wrapper: points/dirs [B, 3] → radiance [B, 3]."""
    out = query_tbl_soa(
        tbl, tuple(points[..., k] for k in range(3)),
        tuple(dirs[..., k] for k in range(3)), t_valid)
    return torch.stack(out, dim=-1)


def query_tbl_multi(tbl: TBL, points: torch.Tensor, dirs: torch.Tensor,
                    t_valid: float = 1e-4) -> torch.Tensor:
    """AoS batched-sample wrapper: points [B, 3], dirs [B, S, 3] →
    [B, S, 3]."""
    b, s, _ = dirs.shape
    pts = tuple(points[:, None, k].expand(b, s) for k in range(3))
    out = query_tbl_soa(tbl, pts, tuple(dirs[..., k] for k in range(3)),
                        t_valid)
    return torch.stack(out, dim=-1)


def query_tbl_fans(tbl: TBL, fan_scene, origins, dirs, fan_normals=None,
                   t_valid: float = 1e-4, max_leaves: int = 512):
    """Fan-structured TBL query: T shared origins × R directions through
    the leaf-budgeted fan trace, the fans that overflow the budget
    re-traced by the BVH (ops.fan_raycast.cast_ray_fans_exact; one host
    sync a call).

    Args:
        origins: 3×[T]; dirs: 3×[T, R]; fan_normals: optional hemisphere
            axes for tangent-plane culling.
    Returns:
        (r, g, b) each [T, R].
    """
    from texir_code_tpu_torch.ops.fan_raycast import cast_ray_fans_exact

    hit = cast_ray_fans_exact(fan_scene, tbl.bvh, origins, dirs, t_min=0.0,
                              max_leaves=max_leaves, fan_normals=fan_normals)
    return radiance_from_hit(tbl, hit, t_valid)


def _row_split(n: int, max_r: int = 2048) -> int:
    """Largest multiple-of-128 row width dividing n (n % 128 == 0)."""
    r = min(max_r, n)
    r -= r % 128
    while r > 128 and n % r:
        r -= 128
    return r


def stream_group_rays(total: int, row_width: int = 2048, fan_block: int = 8,
                      exit_rows: int = 0) -> Tuple[int, int]:
    """(rays of one exit group, row width) of query_tbl_auto's walk over
    `total` rays.  A share of the rays cut at a multiple of the group and
    traced with that row width keeps every ray's candidate list and exit
    group (the walk's groups are rows of the row width, er rows each:
    ops.pallas_culled.walk_args)."""
    r = _row_split(total + (-total) % 128, row_width)
    er = exit_rows if (exit_rows and fan_block % exit_rows == 0) else fan_block
    return r * er, r


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
    two_pass_cut: Optional[float] = None,
    two_pass_cap: float = 0.125,
    proxy=None,
    fan_scene=None,
):
    """Incident radiance along bulk per-ray-origin rays (the fused
    `query_irf`), traced by the culled walk with per-ray origins, or with
    no cluster scene by the exhaustive leaf stream.

    Args:
        origins / dirs: 3-tuples of same-shape tensors whose size is a
            multiple of 128; rows of row_width raster-consecutive rays keep
            the per-row origin boxes (and so the candidate lists) tight.
        cluster_scene: ops.pallas_culled.ClusterScene of the emitter mesh,
            or None to trace against every row of `fan_scene`
            (ops.pallas_fan.cast_rays_pallas_stream; the walk's knobs,
            the two-pass trace, the proxy and the occluders apply only to
            the culled walk).
        rgbe_pre: optional rgbe_prefilter-ed atlas.  With it (and uv rows
            in the scene) the trace interpolates the hit's atlas uv and
            radiance is one nearest RGBE fetch per ray; without it the
            trace returns prim + barycentrics for radiance_from_hit.
        two_pass_cut / two_pass_cap: trace in two passes
            (ops.pallas_culled.cast_fans_culled_twopass); None = one.
        proxy: optional occlusion-proxy ClusterScene that seeds the walk.
        fan_scene: ops.fan_raycast.FanScene, used without a cluster scene.
    Returns:
        (r, g, b) shaped like origins[0]; zero for misses.  Not
        differentiable — lighting is detached in the reference too.
    """
    from texir_code_tpu_torch.ops.fan_raycast import FAN_ROW_WIDTH_UV
    from texir_code_tpu_torch.ops.pallas_culled import (
        cast_fans_culled,
        cast_fans_culled_twopass,
    )
    from texir_code_tpu_torch.ops.pallas_fan import cast_rays_pallas_stream

    shape = origins[0].shape
    total = int(np.prod(shape))
    r = _row_split(total, row_width)
    rows = total // r
    o_rows = tuple(o.reshape(rows, r) for o in origins)
    d_rows = tuple(d.reshape(rows, r) for d in dirs)
    if cluster_scene is None:
        if fan_scene is None:
            raise ValueError("query_tbl_stream needs a cluster_scene or a "
                             "fan_scene")
        emit_uv = (rgbe_pre is not None
                   and fan_scene.rows.shape[1] >= FAN_ROW_WIDTH_UV)
        hit = cast_rays_pallas_stream(fan_scene, o_rows, d_rows, t_min=0.0,
                                      emit_uv=emit_uv)
    else:
        emit_uv = rgbe_pre is not None and cluster_scene.has_uv
        kw = dict(per_ray=True, fan_block=fan_block, exit_rows=exit_rows,
                  emit_uv=emit_uv, proxy=proxy, occluders=occluders)
        if two_pass_cut is not None:
            hit = cast_fans_culled_twopass(
                cluster_scene, o_rows, d_rows, cut_frac=two_pass_cut,
                cap_frac=two_pass_cap, **kw,
            )
        else:
            hit = cast_fans_culled(cluster_scene, o_rows, d_rows, **kw)
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
    The device of the tensors picks the trace: the CUDA kernel on the
    card, its plain version on the CPU (ops.pallas_culled.culled_walk,
    ops.pallas_fan.fan_stream).  With neither a cluster scene nor a
    fan_scene the rays go through the BVH (query_tbl_soa)."""
    if cluster_scene is None and kw.get("fan_scene") is None:
        return query_tbl_soa(tbl, origins, dirs, kw.get("t_valid", 1e-4))
    shape = origins[0].shape
    total = int(np.prod(shape))
    if total == 0:  # a rank's empty share (parallel.mesh)
        return tuple(torch.zeros_like(origins[0]) for _ in range(3))
    pad = (-total) % 128
    if not pad:
        return query_tbl_stream(tbl, origins, dirs, cluster_scene, **kw)

    def flat(a):
        return torch.nn.functional.pad(a.reshape(-1), (0, pad))

    out = query_tbl_stream(tbl, tuple(map(flat, origins)),
                           tuple(map(flat, dirs)), cluster_scene, **kw)
    return tuple(x[:total].reshape(shape) for x in out)
