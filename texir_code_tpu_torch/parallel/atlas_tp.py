"""Atlas tensor parallelism: row-sharded mip pyramids over the ranks.

The port of the JAX package's `parallel/atlas_tp.py` (textures beyond one
device's memory): rank r holds rows [r·H/D, (r+1)·H/D) of each material
atlas, and its parameters, Adam moments, gradients and in-step pyramid
levels live 1/D a rank.

  * The mip chain is built with LOCAL 2×2 pooling while each rank's row
    count stays even (a global 2×2 block never crosses a shard boundary
    then); the last sharded level is gathered (`all_gather_rows`, a few
    KB) and the small tail levels are computed replicated.  No halo
    exchange.
  * A lookup is the sharded-embedding fetch: each rank gathers the
    bilinear corners it OWNS (per-corner owner masks: a corner pair may
    straddle a shard boundary or wrap to row 0), and `psum_replicated`
    over the ranks assembles the bilinear value.
  * Backward: the psum passes the replicated cotangent through, each
    rank's gather scatters into its own shard, and the tail's gather
    hands each rank its rows of the cotangent (parallel.mesh).

The corner math is ops.texture's, and the two mip levels of a trilinear
lookup are summed over the ranks before they are blended, so a lookup
equals `texture_sample` on the whole pyramid bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from texir_code_tpu_torch.parallel.mesh import (
    DeviceMesh,
    all_gather_rows,
    make_device_mesh,
    psum_replicated,
    shard_along,
)


def make_atlas_mesh(n_devices: Optional[int] = None,
                    device=None) -> DeviceMesh:
    """The mesh whose ranks share the atlas rows: the world's ranks, one
    device each (make_device_mesh).  n_devices, when given, must match the
    world's size; device: this rank's device (default: its card, and
    raises on a host without one)."""
    return make_device_mesh(n_devices, device=device)


def _level_shapes(h: int, w: int, max_levels: Optional[int]) -> list:
    """Mip shapes, the stopping rule of ops.texture.build_mip_pyramid."""
    shapes = [(h, w)]
    while True:
        h_, w_ = shapes[-1]
        if h_ < 2 or w_ < 2 or h_ % 2 or w_ % 2:
            break
        if max_levels is not None and len(shapes) >= max_levels + 1:
            break
        shapes.append((h_ // 2, w_ // 2))
    return shapes


@dataclasses.dataclass(frozen=True)
class AtlasTPSpec:
    """Layout of a row-sharded mip pyramid.

    Levels 0..n_big-1 are sharded (H_l divisible by n_shards); the tail is
    replicated.
    """

    n_shards: int
    n_big: int
    n_levels: int
    heights: Tuple[int, ...]       # global H_l
    widths: Tuple[int, ...]
    local_offsets: Tuple[int, ...]  # into a rank's flat big buffer
    tail_offsets: Tuple[int, ...]   # into the replicated flat tail buffer
    big_rows_local: int             # rows of a rank's flat big buffer
    tail_rows: int

    @staticmethod
    def build(h: int, w: int, n_shards: int, max_levels: Optional[int] = None
              ) -> "AtlasTPSpec":
        if h % n_shards:
            raise ValueError(
                f"atlas height {h} not divisible by {n_shards} shards"
            )
        shapes = _level_shapes(h, w, max_levels)
        n_big = sum(1 for (hh, _) in shapes if hh % n_shards == 0)
        local_offsets, tail_offsets = [], []
        big_off = tail_off = 0
        for l, (hh, ww) in enumerate(shapes):
            if l < n_big:
                local_offsets.append(big_off)
                tail_offsets.append(0)
                big_off += (hh // n_shards) * ww
            else:
                local_offsets.append(0)
                tail_offsets.append(tail_off)
                tail_off += hh * ww
        return AtlasTPSpec(
            n_shards=n_shards,
            n_big=n_big,
            n_levels=len(shapes),
            heights=tuple(hh for hh, _ in shapes),
            widths=tuple(ww for _, ww in shapes),
            local_offsets=tuple(local_offsets),
            tail_offsets=tuple(tail_offsets),
            big_rows_local=big_off,
            tail_rows=tail_off,
        )


def _pool2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[0], x.shape[1]
    return x.reshape(h // 2, 2, w // 2, 2, -1).mean(dim=(1, 3))


def tp_build_pyramid_local(tex_local: torch.Tensor, spec: AtlasTPSpec,
                           mesh: DeviceMesh
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows of the base → (flat_big_local, flat_tail).

    flat_big_local: [big_rows_local, C], this rank's rows of every sharded
    level, level-major.  flat_tail: [tail_rows, C], the replicated small
    levels (one zero row when there is no tail)."""
    c = tex_local.shape[-1]
    levels = [tex_local]
    for _ in range(1, spec.n_big):
        levels.append(_pool2(levels[-1]))
    flat_big = torch.cat([l.reshape(-1, c) for l in levels], dim=0)
    if spec.n_levels > spec.n_big:
        last = levels[-1]
        cur = all_gather_rows(last, mesh, [last.shape[0]] * mesh.size)
        tail = []
        for _ in range(spec.n_big, spec.n_levels):
            cur = _pool2(cur)
            tail.append(cur.reshape(-1, c))
        flat_tail = torch.cat(tail, dim=0)
    else:
        flat_tail = tex_local.new_zeros((1, c))
    return flat_big, flat_tail


def tp_fetch_level_local(flat_big, flat_tail, spec: AtlasTPSpec,
                         level: torch.Tensor, uv: torch.Tensor,
                         mesh: DeviceMesh, boundary: str = "wrap"):
    """Masked bilinear fetch at a per-sample level [B] (int64) and uv
    [B, 2].

    Returns (big_part, tail_part): big_part holds only the corners this
    rank owns and must be psum'd; tail_part is replicated and must not
    be."""
    dev = uv.device

    def table(t):
        return torch.tensor(t, dtype=torch.int64, device=dev)

    heights, widths = table(spec.heights), table(spec.widths)
    local_off, tail_off = table(spec.local_offsets), table(spec.tail_offsets)
    h = heights[level]
    w = widths[level]
    x = uv[..., 0] * w.to(uv.dtype) - 0.5
    y = uv[..., 1] * h.to(uv.dtype) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    if boundary == "wrap":
        xs = (torch.remainder(x0i, w), torch.remainder(x0i + 1, w))
        ys = (torch.remainder(y0i, h), torch.remainder(y0i + 1, h))
    else:
        xs = (torch.minimum(x0i.clamp_min(0), w - 1),
              torch.minimum((x0i + 1).clamp_min(0), w - 1))
        ys = (torch.minimum(y0i.clamp_min(0), h - 1),
              torch.minimum((y0i + 1).clamp_min(0), h - 1))

    is_big = level < spec.n_big
    lrows = torch.clamp_min(h // spec.n_shards, 1)
    loff = local_off[level]
    toff = tail_off[level]
    n_big_rows = flat_big.shape[0]
    n_tail_rows = flat_tail.shape[0]

    def corner(r, c_):
        owner = r // lrows
        lr = r - owner * lrows
        # indices of corners another rank owns (or of the other family)
        # are out of range on purpose: clipped, and the owner mask zeroes
        # both the value and its cotangent
        big_idx = (loff + lr * w + c_).clamp(0, n_big_rows - 1)
        t_big = flat_big[big_idx] * (is_big & (owner == mesh.rank))[..., None]
        tail_idx = (toff + r * w + c_).clamp(0, n_tail_rows - 1)
        t_tail = flat_tail[tail_idx] * (~is_big)[..., None]
        return t_big, t_tail

    b00, t00 = corner(ys[0], xs[0])
    b01, t01 = corner(ys[0], xs[1])
    b10, t10 = corner(ys[1], xs[0])
    b11, t11 = corner(ys[1], xs[1])

    def lerp(c00, c01, c10, c11):
        top = c00 * (1 - fx) + c01 * fx
        bot = c10 * (1 - fx) + c11 * fx
        return top * (1 - fy) + bot * fy

    return lerp(b00, b01, b10, b11), lerp(t00, t01, t10, t11)


def tp_sample_local(flat_big, flat_tail, spec: AtlasTPSpec, uv, lod,
                    mesh: DeviceMesh, boundary: str = "wrap") -> torch.Tensor:
    """Trilinear (linear-mipmap-linear) sample from this rank's pyramid
    parts, psum included: the replicated [B, C] result."""
    if lod is None or spec.n_levels == 1:
        lo = torch.zeros(uv.shape[:-1], dtype=torch.int64, device=uv.device)
        big, tail = tp_fetch_level_local(flat_big, flat_tail, spec, lo, uv,
                                         mesh, boundary)
        return psum_replicated(big, mesh) + tail
    lod = torch.clamp(lod, 0.0, spec.n_levels - 1.0)
    lo = torch.floor(lod).to(torch.int64)
    hi = torch.clamp_max(lo + 1, spec.n_levels - 1)
    frac = (lod - lo.to(lod.dtype))[..., None]
    big_lo, tail_lo = tp_fetch_level_local(flat_big, flat_tail, spec, lo, uv,
                                           mesh, boundary)
    big_hi, tail_hi = tp_fetch_level_local(flat_big, flat_tail, spec, hi, uv,
                                           mesh, boundary)
    # both levels in one psum, blended after it: a rank's partial bilinear
    # value holds whole rows of corners and zeros elsewhere, so the sum is
    # the unsharded value exactly, and so is the blend (JAX blends first)
    big = psum_replicated(torch.stack([big_lo, big_hi]), mesh)
    return (big[0] + tail_lo) * (1.0 - frac) + (big[1] + tail_hi) * frac


def atlas_spec(mesh: DeviceMesh, tex_local: torch.Tensor,
               max_levels: Optional[int] = None) -> AtlasTPSpec:
    """The layout of the atlas whose rank-local rows are `tex_local`."""
    return AtlasTPSpec.build(tex_local.shape[0] * mesh.size,
                             tex_local.shape[1], mesh.size, max_levels)


def tp_texture_sample(mesh: DeviceMesh, tex_local: torch.Tensor,
                      uv: torch.Tensor, lod: Optional[torch.Tensor] = None,
                      max_levels: Optional[int] = None,
                      boundary: str = "wrap") -> torch.Tensor:
    """Mip-sample of a row-sharded texture (`tex_local`: this rank's rows;
    uv / lod replicated) → the replicated result; the pyramid is never
    assembled whole."""
    spec = atlas_spec(mesh, tex_local, max_levels)
    flat_big, flat_tail = tp_build_pyramid_local(tex_local, spec, mesh)
    return tp_sample_local(flat_big, flat_tail, spec, uv, lod, mesh, boundary)


def shard_atlas(mesh: DeviceMesh, tex: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole atlas (a contiguous copy)."""
    h = tex.shape[0]
    if h % mesh.size:
        raise ValueError(f"atlas height {h} not divisible by {mesh.size} "
                         "ranks")
    return shard_along(mesh, tex).contiguous()


def gather_atlas(mesh: DeviceMesh, tex_local: torch.Tensor) -> torch.Tensor:
    """The whole atlas from every rank's rows (on every rank)."""
    with torch.no_grad():
        return mesh.all_gather_rows(tex_local.detach().contiguous(),
                                    [tex_local.shape[0]] * mesh.size)


def tp_sample_materials(mesh: DeviceMesh, albedo: torch.Tensor,
                        roughness: torch.Tensor, uv: torch.Tensor,
                        lod_a: torch.Tensor, lod_r: torch.Tensor,
                        max_levels: Optional[int] = None):
    """The Mat step's differentiable fetches with both atlases row-sharded
    (`albedo`, `roughness`: this rank's rows; uv [B, 2], lods [B]
    replicated) → replicated (albedo_px, roughness_px,
    roughness_womip_px): trilinear from each pyramid, and the base level's
    bilinear roughness (the reference's stage-1 path)."""
    alb = tp_texture_sample(mesh, albedo, uv, lod_a, max_levels)
    # the roughness pyramid serves two lookups
    spec_r = atlas_spec(mesh, roughness, max_levels)
    r_big, r_tail = tp_build_pyramid_local(roughness, spec_r, mesh)
    rgh = tp_sample_local(r_big, r_tail, spec_r, uv, lod_r, mesh)
    lvl0 = torch.zeros(uv.shape[:-1], dtype=torch.int64, device=uv.device)
    w_big, w_tail = tp_fetch_level_local(r_big, r_tail, spec_r, lvl0, uv, mesh)
    womip = psum_replicated(w_big, mesh) + w_tail
    return alb, rgh, womip
