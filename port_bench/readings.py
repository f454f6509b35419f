"""What a run hands the per-layer readers (metrics/<name>.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from port_bench.trace import Trace

# NVIDIA H100 SXM, data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12       # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12    # HBM3
FLOPS_PER_TEST = 30           # one plane-dual ray x triangle test


@dataclasses.dataclass
class WalkWork:
    """The work the walk's inputs need (port_bench.roofline): triangle
    tests and bytes, summed over the traced units."""

    tests: int
    nbytes: int

    @property
    def bound_ms(self) -> float:
        """The least time the card needs: the larger of the tests at the
        float32 peak and the bytes at the memory bandwidth."""
        return max(self.tests * FLOPS_PER_TEST / PEAK_FP32_FLOPS,
                   self.nbytes / PEAK_BYTES_PER_S) * 1e3


@dataclasses.dataclass
class Readings:
    kind: str                 # "bake" or "mat": what the cell drives
    units: int                # bake batches or Mat steps in the window
    trace: Optional[Trace]    # the traced window
    host: dict                # host-clock readings (pack_s, step_ms, ...)
    walk: Optional[WalkWork] = None

    def per_unit(self, x: float) -> float:
        return x / max(self.units, 1)
