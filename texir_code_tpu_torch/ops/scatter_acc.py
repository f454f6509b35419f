"""Scatter-accumulate — the texture sampler's gather transposed.

For taps `idx[N]` in [0, S) and rows `g[N, C]`,

    scatter_accumulate(idx, g, S)[s] = sum of g[n] over the n with idx[n] = s,

which is `jnp.zeros((S, C)).at[idx].add(g)` in the JAX package.  It is the
backward of `flat[idx]` and so of every texel fetch of the mip sampler
(ops.texture.take_segsum).  The JAX package measures it in two Pallas
harnesses (scripts/sampler_bwd_variants2.py, kernel S1, and
scripts/sampler_bwd_variants3.py, kernel S2); the port runs it through
the hand-written kernel `csrc/scatter_acc.cu` on CUDA tensors
(`scatter_accumulate_cuda`, modes "unsorted" and "sorted") and through
`scatter_accumulate_plain` (zeros + `index_add_` in tap order) on CPU
tensors.  On a CUDA tensor a kernel that fails to build or launch raises;
nothing falls back to the plain version.
"""

from __future__ import annotations

import collections
import ctypes

import torch


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
        fn.argtypes = [p, p, ll, i, ll, i, p, p]
    return lib


def scatter_mode(presorted: bool) -> str:
    """Name of a kernel mode, as `scatter_accumulate_cuda.launches` counts
    it: 'sorted' for taps sorted by index, else 'unsorted'."""
    return "sorted" if presorted else "unsorted"


def scatter_accumulate_cuda(idx: torch.Tensor, g: torch.Tensor,
                            num_rows: int,
                            presorted: bool = False) -> torch.Tensor:
    """Launch `csrc/scatter_acc.cu` on the current stream.

    idx: [N] int32 or int64 on the card (int64 is cast to int32); g: [N, C]
    float32 on the card.  Adds one to
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
        raise TypeError(f"idx: expected an integer tensor, got {idx.dtype}")
    idx32 = idx.to(torch.int32).contiguous()
    g = g.contiguous()
    n, c = g.shape
    out = torch.zeros((num_rows, c), dtype=torch.float32, device=dev)
    lib = _scatter_acc_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.texir_scatter_acc(idx32.data_ptr(), g.data_ptr(), n, c,
                                    num_rows, int(presorted), out.data_ptr(),
                                    stream)
    if err != 0:
        raise RuntimeError(f"scatter_acc launch failed: cudaError {err}")
    scatter_accumulate_cuda.launches[scatter_mode(presorted)] += 1
    return out


# launches per kernel mode (scatter_mode); callers reset it with .clear()
scatter_accumulate_cuda.launches = collections.Counter()


def scatter_accumulate(idx: torch.Tensor, g: torch.Tensor, num_rows: int,
                       presorted: bool = False) -> torch.Tensor:
    """out[S, C] with out[s] = sum of g[n] over idx[n] = s.

    Args:
        idx: [N] integer taps in [0, num_rows).
        g: [N, C] float32 rows.
        num_rows: S, the rows of the output.
        presorted: the taps are sorted by index (kernel mode 'sorted': one
            add per run of equal indices); any order gives the same sums.
    Returns:
        [S, C] float32.

    On CUDA tensors this launches the CUDA kernel (scatter_accumulate_cuda);
    on CPU tensors it runs scatter_accumulate_plain."""
    if g.device.type == "cuda":
        return scatter_accumulate_cuda(idx, g, num_rows, presorted)
    if g.device.type == "cpu":
        return scatter_accumulate_plain(idx, g, num_rows)
    raise ValueError(f"scatter_accumulate: unsupported device {g.device}")
