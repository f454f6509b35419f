"""Profiling and observability: step timers, throughput counters, traces,
and the program's own spans and counters.

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

**Spans.**  The program marks its stages with `span(name)`: while a torch
profiler records (`trace()`, or any `torch.profiler.profile`), a span is a
`record_function` range named `texir.<name>`, kept in memory by the
profiler beside the host ops and the CUDA kernels they launch, on the same
clock; otherwise it is one flag check.  So `trace()` writes a trace whose
`texir.*` ranges stand above the kernels of each stage:

    with trace("/tmp/tb"):
        baker.bake_batch(points, normals, ids, seed)
    # texir.bake.batch > texir.bake.dirs, texir.cull, texir.walk,
    # texir.twopass.sync, texir.twopass.retrace, texir.bake.estimate

**Counters.**  One registry of `collections.Counter`s: `counter(name)`
returns one (made on first use) and `counters()` a flat snapshot,
`{"<name>.<key>": value}`.  When each counts:
  * always, a Python add of a value already on the host: the kernel
    launches (`culled_walk.launches`, `fan_stream.launches`,
    `scatter_acc.launches`, by mode), the collectives and their bytes
    (`collectives`), the two-pass trace's calls and overflows (`twopass`),
    and the host seconds of the scene packing (`pack`: bvh, tbl, fan,
    clusters, occluders, texels);
  * only while a profiler records, so that they cover the traced window
    alone: the two-pass trace's pass-1 rays and stragglers
    (`twopass.rays`), and the cull's (exit group, cluster) pairs and
    candidates (`cull`).  The candidate counts live on the device: each
    is held as a reference to its tensor and reduced when `counters()`
    reads the registry, so a traced window gains no launch and no sync.
    The held values are also reduced when `trace()` ends; under another
    profiler, read `counters()` or call `reset_counters()` after it.
Counters count over the whole process; `reset_counters()` zeroes them.
The modules' own names for them (`culled_walk_cuda.launches`,
`cast_fans_culled_twopass.counts`, `parallel.mesh.COUNTS`, ...) are the
registry's objects.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

SPAN_PREFIX = "texir."
_NO_SPAN = contextlib.nullcontext()

_REGISTRY: Dict[str, collections.Counter] = {}
# (counter, key, tensor): device values to add when the registry is read
_HELD: List[Tuple[collections.Counter, str, torch.Tensor]] = []
# past this many, the held values of a key are summed on their device
_HELD_MAX = 256


def recording() -> bool:
    """True while a torch profiler records in this process."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """`with span("cull"): ...` opens the range `texir.cull` while a torch
    profiler records, and nothing otherwise."""
    if not recording():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def counter(name: str) -> collections.Counter:
    """The registry's counter `name`, made on first use."""
    c = _REGISTRY.get(name)
    if c is None:
        c = _REGISTRY[name] = collections.Counter()
    return c


def hold(name: str, key: str, value: torch.Tensor) -> None:
    """Add value.sum() to counter(name)[key] when the registry is next
    read, if a profiler records now; nothing otherwise.  Only a reference
    is kept, and nothing syncs here (past _HELD_MAX held values, each
    key's are summed on their device)."""
    if recording():
        _HELD.append((counter(name), key, value))
        if len(_HELD) > _HELD_MAX:
            _compact_held()


def _compact_held() -> None:
    """Sum the held values of each counter key and device into one
    tensor: the list stays short in a long traced run, with no sync."""
    groups = {}
    for c, key, value in _HELD:
        g = groups.setdefault((id(c), key, value.device), (c, key, []))
        g[2].append(value.reshape(-1).to(torch.int64))
    _HELD[:] = [(c, key, torch.cat(vs).sum()) for c, key, vs
                in groups.values()]


def _fold_held() -> None:
    """Add the held device values to their counters (a device-to-host
    read each)."""
    held = _HELD[:]
    del _HELD[:]
    for c, key, value in held:
        c[key] += int(value.sum())


def counters() -> Dict[str, float]:
    """A snapshot of the registry, {"<counter>.<key>": value}, after the
    held device values are reduced."""
    _fold_held()
    return {f"{name}.{key}": v for name, c in _REGISTRY.items()
            for key, v in c.items()}


def reset_counters() -> None:
    """Zero every counter (the objects stay) and drop the held values."""
    for c in _REGISTRY.values():
        c.clear()
    del _HELD[:]


def timed(name: str, key: str) -> Callable:
    """Decorator: each call's host seconds added to counter(name)[key]."""

    def wrap(fn):
        @functools.wraps(fn)
        def timed_call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                counter(name)[key] += time.perf_counter() - t0

        return timed_call

    return wrap


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block: CPU activity, and CUDA activity
    whenever a card is present.  On exit it writes one trace under
    `logdir` (`<worker>.<time>.pt.trace.json`, which TensorBoard's profiler
    plugin and chrome://tracing open), and reduces the device values the
    counters held meanwhile.  Yields the profiler, so the caller can read
    `key_averages()`."""
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
    _fold_held()


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
