"""What the program records about itself, for the per-layer readers: its
`texir.*` spans in a traced window (texir_code_tpu_torch.profiling.span,
torch.profiler ranges that the window keeps among its host operations)
and its counters (texir_code_tpu_torch.profiling.counters).  A program
that records neither gives no spans and no counters, never an error."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "texir."


def spans(trace, name: str) -> list:
    """The host intervals of the program's span `name` that lie inside the
    traced window."""
    full = SPAN_PREFIX + name
    lo, hi = trace.window
    return [iv for iv in trace.host
            if iv.name == full and iv.start >= lo and iv.end <= hi]


def merged(ivs) -> List[Tuple[int, int]]:
    """The union of intervals, as sorted disjoint (start, end) pairs."""
    out: List[List[int]] = []
    for iv in sorted(ivs, key=lambda iv: iv.start):
        if out and iv.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], iv.end)
        else:
            out.append([iv.start, iv.end])
    return [(a, b) for a, b in out]


def count_inside(times: List[int], ivs: List[Tuple[int, int]]) -> int:
    """How many of the sorted `times` fall inside the disjoint intervals."""
    return sum(bisect.bisect_left(times, b) - bisect.bisect_left(times, a)
               for a, b in ivs)


def idle_ns(trace, ivs: List[Tuple[int, int]]) -> int:
    """Device-idle ns inside the disjoint intervals `ivs`: their length
    less the time the device ran an operation in them."""
    busy = trace.busy_intervals()
    total = 0
    for a, b in ivs:
        total += b - a
        for x, y in busy:
            total -= max(0, min(b, y) - max(a, x))
    return total


def counters() -> Optional[Dict[str, float]]:
    """The program's counters, or None where it keeps none."""
    try:
        from texir_code_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return read() if callable(read) else None
