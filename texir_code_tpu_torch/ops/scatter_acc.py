"""Scatter-accumulate — the texture sampler's gather transposed.

For taps `idx[N]` in [0, S) and rows `g[N, C]`,

    scatter_accumulate(idx, g, S)[s] = sum of g[n] over the n with idx[n] = s,

which is `jnp.zeros((S, C)).at[idx].add(g)` in the JAX package.  It is the
backward of `flat[idx]` and so of every texel fetch of the mip sampler
(ops.texture.take_segsum).  The JAX package measures it in two Pallas
harnesses (scripts/sampler_bwd_variants2.py, kernel S1, and
scripts/sampler_bwd_variants3.py, kernel S2); the port runs it through
the hand-written kernel `csrc/scatter_acc.cu` on CUDA tensors
(`scatter_accumulate_cuda`, modes "unsorted" and "sorted", the latter on
ascending taps only) and through
`scatter_accumulate_plain` (zeros + `index_add_` in tap order) on CPU
tensors.  On a CUDA tensor a kernel that fails to build or launch raises;
nothing falls back to the plain version.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict

import torch

from texir_code_tpu_torch import profiling


def scatter_accumulate_plain(idx: torch.Tensor, g: torch.Tensor,
                             num_rows: int) -> torch.Tensor:
    """The plain version: `torch.zeros(S, C)` plus `index_add_` of the
    rows in tap order (sequential on the CPU).  idx [N] integer, g [N, C]
    float32 → [S, C] float32."""
    out = torch.zeros((num_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, idx.to(torch.int64), g)


def _scatter_acc_lib() -> ctypes.CDLL:
    from texir_code_tpu_torch.ops import cuda_build

    lib = cuda_build.load("scatter_acc")
    fn = lib.texir_scatter_acc
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.restype = ctypes.c_int
        fn.argtypes = [p, i, p, ll, i, i, i, i, p, p, ctypes.c_uint, p]
        blocks = lib.texir_scatter_acc_blocks
        blocks.restype = ll
        blocks.argtypes = [ll, i, i]
    return lib


def scatter_mode(presorted: bool) -> str:
    """Name of a kernel mode, as `scatter_accumulate_cuda.launches` counts
    it: 'sorted' for taps in ascending index order, else 'unsorted'."""
    return "sorted" if presorted else "unsorted"


_SORTED_MAX_C = 4    # channels of one sorted-mode launch (csrc: kC <= 4)
_EPOCH_LIMIT = 1 << 30


class _Scratch:
    """The sorted mode's hand-off between blocks on one stream of one
    device: `carries` (int64, 4 a block: each a tag and one channel's
    partial sum), zeroed once and grown as needed; `epoch`, numbered by
    the host, tells this launch's tags from the last one's.  It is safe
    only while the launches that share it run in order, so each stream
    has its own, and no launch is captured in a CUDA graph (a replay
    would reuse the epoch and could accept an earlier replay's carry)."""

    def __init__(self):
        self.carries = None
        self.epoch = 0

    def take(self, blocks: int, dev) -> tuple:
        if self.carries is None or self.carries.numel() < 4 * blocks:
            self.carries = torch.zeros(4 * blocks, dtype=torch.int64,
                                       device=dev)
            self.epoch = 0
        self.epoch += 1
        if self.epoch >= _EPOCH_LIMIT:  # stale tags could match: start over
            self.carries.zero_()
            self.epoch = 1
        return self.carries, self.epoch


# one scratch per (device, stream handle)
_scratch: Dict[tuple, _Scratch] = collections.defaultdict(_Scratch)


def scatter_accumulate_cuda(idx: torch.Tensor, g: torch.Tensor,
                            num_rows: int,
                            presorted: bool = False) -> torch.Tensor:
    """Launch `csrc/scatter_acc.cu` on the current stream.

    idx: [N] int32 or int64 on the card, taken as it is; g: [N, C] float32
    on the card.  presorted: idx is in ascending order (the 'sorted'
    mode's contract: unsorted taps give an undefined result); the output
    is then written once, without a zero fill (`torch.empty`), in launches
    of at most 4 channels; it cannot be captured in a CUDA graph (raises
    while the current stream is capturing, see _Scratch).  Else the
    'unsorted' mode adds into `torch.zeros`.  Adds one to
    `scatter_accumulate_cuda.launches[scatter_mode(presorted)]` per launch."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_accumulate_cuda needs CUDA tensors, got {dev}")
    if not 0 < num_rows < 2 ** 31:
        raise ValueError(f"num_rows must be in (0, 2^31), got {num_rows}")
    if g.dtype != torch.float32 or g.dim() != 2:
        raise TypeError(f"g: expected float32 [N, C], got {g.dtype} "
                        f"{tuple(g.shape)}")
    if idx.dim() != 1 or idx.shape[0] != g.shape[0] or idx.device != dev:
        raise ValueError(f"idx: expected [{g.shape[0]}] on {dev}, got "
                         f"{tuple(idx.shape)} on {idx.device}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx: expected int32 or int64, got {idx.dtype}")
    if presorted and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "scatter_accumulate_cuda(presorted=True) cannot be captured in "
            "a CUDA graph: its blocks hand partial sums on through tags the "
            "host numbers per launch, which a replay would reuse")
    idx = idx.contiguous()
    g = g.contiguous()
    n, c = g.shape
    lib = _scatter_acc_lib()
    mode = scatter_mode(presorted)
    alloc = torch.empty if presorted else torch.zeros
    out = alloc((num_rows, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _scratch[(dev, stream)]
        for k in range(0, c, _SORTED_MAX_C) if presorted else (0,):
            width = min(_SORTED_MAX_C, c - k) if presorted else c
            carries, epoch = None, 0
            if presorted:  # a new epoch for each launch on the scratch
                carries, epoch = scratch.take(
                    lib.texir_scatter_acc_blocks(n, num_rows, width), dev)
            err = lib.texir_scatter_acc(
                idx.data_ptr(), idx.element_size(), g.data_ptr() + 4 * k, n,
                width, c, num_rows, int(presorted), out.data_ptr() + 4 * k,
                None if carries is None else carries.data_ptr(), epoch,
                stream)
            if err != 0:
                raise RuntimeError(
                    f"scatter_acc launch failed: cudaError {err}")
            scatter_accumulate_cuda.launches[mode] += 1
    return out


# launches per kernel mode (scatter_mode); callers reset it with .clear()
scatter_accumulate_cuda.launches = profiling.counter("scatter_acc.launches")


def scatter_accumulate(idx: torch.Tensor, g: torch.Tensor, num_rows: int,
                       presorted: bool = False) -> torch.Tensor:
    """out[S, C] with out[s] = sum of g[n] over idx[n] = s.

    Args:
        idx: [N] integer taps in [0, num_rows).
        g: [N, C] float32 rows.
        num_rows: S, the rows of the output.
        presorted: the taps are in ascending index order (kernel mode
            'sorted': one deterministic pass that writes each output row
            once).  On the card this is a contract: taps out of order
            give an undefined result there; the CPU path takes any order.
    Returns:
        [S, C] float32.

    On CUDA tensors this launches the CUDA kernel (scatter_accumulate_cuda);
    on CPU tensors it runs scatter_accumulate_plain."""
    if g.device.type == "cuda":
        return scatter_accumulate_cuda(idx, g, num_rows, presorted)
    if g.device.type == "cpu":
        return scatter_accumulate_plain(idx, g, num_rows)
    raise ValueError(f"scatter_accumulate: unsupported device {g.device}")
