"""Pixel-chunked evaluation — the reference's split_input / merge_output
(reference utils/general.py:28-58).

The port of the JAX package's `ops/chunking.py`.  High-spp evaluation
(diffuse 1024 / specular 256 per configs/test.conf:10) would hold
[98k px × 256 spp] intermediates at once — several GB.  `map_chunked`
runs a shading closure over fixed-size pixel chunks in turn, so peak
memory is one chunk's intermediates.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def map_chunked(
    fn: Callable,
    args: Tuple[torch.Tensor, ...],
    chunk: int,
):
    """Apply `fn` over leading-axis chunks of `args` and concatenate.

    Args:
        fn: takes the tuple of per-chunk tensors ([chunk, ...] each) and
            returns a tuple of [chunk, ...] tensors.  Closure over unchunked
            values (params, pyramids, scene constants) is fine.
        args: tensors sharing leading dimension B.
        chunk: pixels per chunk; B is zero-padded up to a multiple, as the
            JAX package pads it.
    Returns:
        tuple of [B, ...] outputs.
    """
    b = args[0].shape[0]
    pad = (-b) % chunk
    if pad:
        args = tuple(
            torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            for x in args
        )
    outs = [fn(tuple(x[s:s + chunk] for x in args))
            for s in range(0, b + pad, chunk)]
    return tuple(torch.cat(parts)[:b] for parts in zip(*outs))
