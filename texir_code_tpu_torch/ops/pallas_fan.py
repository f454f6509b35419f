"""Exhaustive leaf stream — closest hits against every leaf row of a FanScene.

The port of the JAX package's `ops/pallas_fan.py`: every ray of a [T, R]
row block is tested against every FanScene leaf row, 4 triangles a row in
plane-dual form, with the closest-hit state held per ray.  It serves a
scene that has a FanScene and no ClusterScene:

  * `cast_ray_fans_pallas` (kernel B2): one shared origin per row of rays
    — the bake's texel fans (with `emit_uv`) and a camera's pixel rows;
  * `cast_rays_pallas_stream` (kernel B3): one origin per ray — the
    specular trace of the Mat step.

On CUDA tensors both launch the hand-written kernel `csrc/fan_stream.cu`
(`fan_stream_cuda`); on CPU tensors they run `fan_stream_plain`, the same
arithmetic in plain PyTorch and the kernel's oracle.  The scene's rows and
the kernel's packed triangle records go to the device once per scene
(`FanScene.device_rows`, `FanScene.device_records`).

The file keeps the JAX module's name so each counterpart is easy to find;
nothing in it is Pallas.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from texir_code_tpu_torch import profiling
from texir_code_tpu_torch.ops.fan_raycast import (
    FAN_ROW_WIDTH,
    FAN_ROW_WIDTH_UV,
    _TRI_BASE,
    _TRI_STRIDE,
    _UV_BASE,
    FanScene,
    closest_hit_block,
    pack_records,
)
from texir_code_tpu_torch.ops.pallas_culled import _check
from texir_code_tpu_torch.ops.raycast import RayHit, Vec3s

_PLAIN_BLOCK = 8  # leaf rows the plain version tests at once


def fan_stream_plain(rows, origins, dx, dy, dz, t_min: float = 0.0,
                     emit_uv: bool = False, per_ray: bool = False):
    """The stream in plain PyTorch: the CPU path and the kernel's oracle.

    Same arguments and results as `fan_stream`.  It tests a block of
    `_PLAIN_BLOCK` leaf rows (4 triangles each) at once
    (ops.fan_raycast.closest_hit_block), which keeps the sequential
    stream's first-in-row-order tie rule."""
    n_rows, r = dx.shape
    dev = dx.device
    if per_ray:
        o = tuple(origins[k][None] for k in range(3))            # [1, T, R]
    else:
        o = tuple(origins[:, k].reshape(1, n_rows, 1) for k in range(3))
    d = tuple(a[None] for a in (dx, dy, dz))
    hit = (torch.full((1, n_rows, r), float("inf"), device=dev),
           torch.full((1, n_rows, r), -1, dtype=torch.int32, device=dev),
           torch.zeros((1, n_rows, r), device=dev),
           torch.zeros((1, n_rows, r), device=dev))
    for l0 in range(0, rows.shape[0], _PLAIN_BLOCK):
        blk = rows[l0:l0 + _PLAIN_BLOCK]
        k = 4 * blk.shape[0]
        tri = blk[:, _TRI_BASE:_TRI_BASE + 4 * _TRI_STRIDE].reshape(1, k, -1)
        uvc = (blk[:, _UV_BASE:_UV_BASE + 24].reshape(1, k, 6)
               if emit_uv else None)
        pids = blk[:, 8:12].contiguous().view(torch.int32).reshape(1, k)
        hit = closest_hit_block(tri, uvc, pids, o, d, hit, t_min, emit_uv)
    return tuple(a[0] for a in hit)


def _fan_stream_lib() -> ctypes.CDLL:
    from texir_code_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fan_stream")
    fn = lib.texir_fan_stream
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, i, p, i, p, p, p, p, i, i, f, i, i, i, i,
                       p, p, p, p, p]
    return lib


def launch_plan(n_rays: int, sms: int):
    """(rays per thread, threads per block) of a launch over n_rays rays:
    4 rays a thread in blocks of 256 where that still gives every SM two
    blocks, else 2 rays a thread in the largest block (256, 128, 64) that
    does, so that a small launch (a G-buffer's 98,304 rays) fills the card."""
    want = 2 * sms
    if n_rays >= want * 256 * 4:
        return 4, 256
    for threads in (256, 128):
        if n_rays >= want * threads * 2:
            return 2, threads
    return 2, 64


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_mode(per_ray: bool, emit_uv: bool) -> str:
    """Name of a kernel mode, as `fan_stream_cuda.launches` counts it:
    'shared' or 'per_ray' origins, then '_uv' (atlas uv) or '_prim'
    (barycentrics).  The FanScene-only bake runs 'shared_uv', its G-buffer
    'shared_prim', its specular trace 'per_ray_uv'."""
    return ("per_ray" if per_ray else "shared") + ("_uv" if emit_uv else "_prim")


def fan_stream_cuda(rows, origins, dx, dy, dz, t_min: float = 0.0,
                    emit_uv: bool = False, per_ray: bool = False,
                    records=None):
    """Launch `csrc/fan_stream.cu` on the current stream (see fan_stream).

    records: pack_records(rows) (FanScene.device_records caches them;
    the kernel reads the hit's prim and uv from `rows` at the records'
    slots, so they must come from these rows); packed here when None.
    Adds one to `fan_stream_cuda.launches[stream_mode(...)]` per launch."""
    dev = dx.device
    if dev.type != "cuda":
        raise ValueError(f"fan_stream_cuda needs CUDA tensors, got {dev}")
    n_rows, r = dx.shape
    n_leaves, width = rows.shape
    _check("rows", rows, torch.float32, (n_leaves, width), dev)
    if width < FAN_ROW_WIDTH:
        raise ValueError(f"rows must be FanScene rows (width 72 or 96), "
                         f"got {width}")
    if emit_uv and width < FAN_ROW_WIDTH_UV:
        raise ValueError("emit_uv requires a FanScene built with triangle_uvs")
    if per_ray:
        _check("origins (per_ray: [3, rows, R])", origins, torch.float32,
               (3, n_rows, r), dev)
    else:
        _check("origins (shared: [rows, 3])", origins, torch.float32,
               (n_rows, 3), dev)
    for name, a in (("dx", dx), ("dy", dy), ("dz", dz)):
        _check(name, a, torch.float32, (n_rows, r), dev)
    rec, slots = pack_records(rows) if records is None else records
    n_rec = rec.shape[0]
    _check("records", rec, torch.float32, (n_rec, 12), dev)
    _check("slots", slots, torch.int32, (n_rec,), dev)
    if rec.data_ptr() % 16:
        raise ValueError("records must be 16-byte aligned")
    rays_per_thread, threads = launch_plan(n_rows * r, sm_count(dev.index))
    shape = (n_rows, r)
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    prim = torch.empty(shape, dtype=torch.int32, device=dev)
    u = torch.empty(shape, dtype=torch.float32, device=dev)
    v = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _fan_stream_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.texir_fan_stream(
            rec.data_ptr(), slots.data_ptr(), n_rec, rows.data_ptr(), width,
            origins.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
            n_rows, r, float(t_min), int(per_ray), int(emit_uv),
            rays_per_thread, threads, t.data_ptr(), prim.data_ptr(),
            u.data_ptr(), v.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fan_stream launch failed: cudaError {err}")
    fan_stream_cuda.launches[stream_mode(per_ray, emit_uv)] += 1
    return t, prim, u, v


# launches per kernel mode (stream_mode); callers reset it with .clear()
fan_stream_cuda.launches = profiling.counter("fan_stream.launches")


def fan_stream(rows, origins, dx, dy, dz, t_min: float = 0.0,
               emit_uv: bool = False, per_ray: bool = False, records=None):
    """Closest hits of ray rows against every leaf row.

    Args:
        rows: [L, 72 | 96] float32 FanScene rows on the rays' device.
        origins: [T, 3] float32, one shared origin per row; with per_ray,
            [3, T, R] float32, one origin per ray.
        dx, dy, dz: [T, R] float32 directions.
        t_min: hits need t > t_min.
        emit_uv: (u, v) become the atlas uv of the hit (rows of width 96).
        records: pack_records(rows), for the CUDA kernel (packed there
            when None).
    Returns:
        (t, prim, u, v), each [T, R]: t = +inf and prim = -1 on miss.

    On CUDA tensors this launches the CUDA kernel (fan_stream_cuda); on
    CPU tensors it runs fan_stream_plain."""
    args = (rows, origins, dx, dy, dz, t_min, emit_uv, per_ray)
    if dx.device.type == "cuda":
        return fan_stream_cuda(*args, records=records)
    if dx.device.type == "cpu":
        return fan_stream_plain(*args)
    raise ValueError(f"fan_stream: unsupported device {dx.device}")


def _stream(scene: FanScene, o_pack, dirs: Vec3s, t_min: float,
            emit_uv: bool, per_ray: bool) -> RayHit:
    r = dirs[0].shape[1]
    if r % 128:
        raise ValueError(f"rays per row must be a multiple of 128, got {r}")
    if emit_uv and scene.rows.shape[1] < FAN_ROW_WIDTH_UV:
        raise ValueError("emit_uv requires a FanScene built with triangle_uvs")
    dev = dirs[0].device
    t, prim, u, v = fan_stream(
        scene.device_rows(dev), o_pack, *(a.contiguous() for a in dirs),
        t_min=t_min, emit_uv=emit_uv, per_ray=per_ray,
        records=scene.device_records(dev) if dev.type == "cuda" else None)
    return RayHit(t=t, prim=prim, u=u, v=v)


def cast_ray_fans_pallas(
    scene: FanScene,
    origins: Vec3s,
    dirs: Vec3s,
    t_min: float = 0.0,
    fan_block: int = 8,
    leaf_block: int = 16,
    fan_chunk: int = 4096,
    emit_uv: bool = False,
) -> RayHit:
    """Exhaustive shared-origin fan intersection (kernel B2).

    Args:
        origins: 3×[T] per-fan origins; dirs: 3×[T, R] (R a multiple of
            128).
        emit_uv: (u, v) of the result are the interpolated atlas uv of the
            hit instead of barycentrics (rows with triangle uvs).
        fan_block / leaf_block / fan_chunk: the TPU kernel's tile sizes and
            launch chunking, accepted for its signature.  They change no
            output: the CUDA kernel covers any row count, and the zero leaf
            rows the TPU kernel pads to whole leaf blocks never hit.
    Returns:
        RayHit of shape [T, R]; prim is the hit triangle in every mode.
    """
    del fan_block, leaf_block, fan_chunk
    o_pack = torch.stack(tuple(origins), dim=-1).contiguous()  # [T, 3]
    return _stream(scene, o_pack, dirs, t_min, emit_uv, per_ray=False)


def cast_rays_pallas_stream(
    scene: FanScene,
    origins: Vec3s,
    dirs: Vec3s,
    t_min: float = 0.0,
    fan_block: int = 8,
    leaf_block: int = 32,
    emit_uv: bool = False,
) -> RayHit:
    """Exhaustive leaf-stream intersection with per-ray origins (kernel B3).

    Args:
        origins / dirs: 3-tuples of [T, R] float32 (R a multiple of 128).
        fan_block / leaf_block: accepted for the JAX signature; they change
            no output.
    Returns:
        RayHit of shape [T, R].
    """
    del fan_block, leaf_block
    o_pack = torch.stack(tuple(origins), dim=0).contiguous()  # [3, T, R]
    return _stream(scene, o_pack, dirs, t_min, emit_uv, per_ray=True)
