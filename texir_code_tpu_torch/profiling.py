"""Profiling and observability: step timers, throughput counters, traces.

The port of the JAX package's `profiling.py`.  Throughput (rays/s,
texels/s) is first-class, and torch.profiler is one context manager away:

    with trace("/tmp/tb") as prof:  # open in TensorBoard or Chrome
        run_step()

    timer = StepTimer()
    with timer.measure(rays=1_570_000):
        step()
        torch.cuda.synchronize()    # the step ends on the card, not at enqueue
    print(timer.summary())          # iters/s, Mrays/s, p50/p95 step time

StepTimer reads the host clock.  CUDA launches return before the card has
finished, so a caller that times work on the card ends each measured step
in a device sync (`torch.cuda.synchronize()` or a device-to-host copy of a
result); otherwise it times the enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block: CPU activity, and CUDA activity
    whenever a card is present.  On exit it writes one trace under
    `logdir` (`<worker>.<time>.pt.trace.json`, which TensorBoard's profiler
    plugin and chrome://tracing open).  Yields the profiler, so the caller
    can read `key_averages()`."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class StepTimer:
    """Wall-clock step timer with work counters."""

    def __init__(self):
        self.times: List[float] = []
        self.work: Dict[str, float] = {}

    @contextlib.contextmanager
    def measure(self, **counts: float):
        """Time one step; counts (rays=..., texels=..., pixels=...) accumulate."""
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        for k, v in counts.items():
            self.work[k] = self.work.get(k, 0.0) + v

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        total = float(t.sum())
        out = {
            "steps": len(t),
            "iters_per_s": len(t) / total,
            "step_p50_ms": float(np.percentile(t, 50) * 1e3),
            "step_p95_ms": float(np.percentile(t, 95) * 1e3),
        }
        for k, v in self.work.items():
            out[f"{k}_per_s"] = v / total
            if v / total > 1e6:
                out[f"M{k}_per_s"] = v / total / 1e6
        return out
