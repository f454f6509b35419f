"""What a traced window holds: device time by kernel and by the
harness's spans, launches, the device's busy and idle time, and the
longest idle gaps by what the host was doing.

The spans are `torch.profiler.record_function` ranges that the harness
opens from its own files around calls into the program (`span`).  A
span's device time is that of the kernels launched inside it: each
kernel is tied to its launch by the profiler's correlation id.  The
events are read raw (`kineto_results.events()`), without building the
profiler's event tree.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "port_bench."  # the harness's span names
NAME_CHARS = 96         # a kernel's name in the breakdown is cut here

_TRACING = {"on": False}


@contextlib.contextmanager
def span(name: str):
    """A named range in the trace while a traced window is open; nothing
    otherwise."""
    if not _TRACING["on"]:
        yield
        return
    with torch.profiler.record_function(PREFIX + name):
        yield


def spanned(fn: Callable, name: str) -> Callable:
    """fn wrapped in span(name)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def patched(module, attr: str, name: str):
    """module.attr wrapped in span(name) for the duration."""
    orig = getattr(module, attr)
    setattr(module, attr, spanned(orig, name))
    try:
        yield
    finally:
        setattr(module, attr, orig)


@contextlib.contextmanager
def traced_window(device):
    """Profile host and device activity; yields a holder whose .trace is
    the analysed window (a Trace) once the block has ended.  The window
    ends in a device sync."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    holder = type("Holder", (), {"trace": None})()
    _TRACING["on"] = True
    try:
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(PREFIX + "window"):
                yield holder
                if cuda:
                    torch.cuda.synchronize(device)
    finally:
        _TRACING["on"] = False
    holder.trace = analyse(prof.profiler.kineto_results.events())


@dataclasses.dataclass
class Interval:
    start: int  # ns
    end: int
    name: str


_LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
           "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
           "cudaLaunchCooperativeKernel")


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]
    kernels: List[Tuple[Interval, Optional[str]]]  # device op, its span
    copies: List[Interval]
    host: List[Interval]     # CPU ops and runtime calls
    spans: List[Interval]    # the harness's ranges

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _clip(self, iv: Interval):
        return max(iv.start, self.window[0]), min(iv.end, self.window[1])

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """Merged intervals in which the device ran an operation."""
        ivs = sorted(self._clip(iv) for iv in
                     [k for k, _ in self.kernels] + self.copies)
        merged: List[List[int]] = []
        for a, b in ivs:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    @property
    def launches(self) -> int:
        return len(self.kernels)

    def kernel_ms(self, match: Callable[[str], bool]) -> float:
        """Device ms of the kernels whose name matches."""
        return sum(iv.end - iv.start for iv, _ in self.kernels
                   if match(iv.name)) / 1e6

    def span_ms(self, name: str) -> float:
        """Device ms of the kernels launched inside span `name`."""
        full = PREFIX + name
        return sum(iv.end - iv.start for iv, s in self.kernels
                   if s == full) / 1e6

    def span_count(self, name: str) -> int:
        return sum(1 for s in self.spans if s.name == PREFIX + name)

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time, in seconds."""
        by: Dict[str, float] = {}
        for iv, _ in self.kernels:
            by[iv.name] = by.get(iv.name, 0.0) + (iv.end - iv.start) / 1e9
        for iv in self.copies:
            by[iv.name] = by.get(iv.name, 0.0) + (iv.end - iv.start) / 1e9
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest gaps with no device operation inside the window,
        each named by the harness span and the host operation under way
        when it began, in seconds."""
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [
            self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            out.append([self._host_at(a), (b - a) / 1e9])
        return out

    def _host_at(self, t: int) -> str:
        def inner(ivs):
            best = None
            for iv in ivs:
                if iv.start <= t < iv.end and (
                        best is None or iv.end - iv.start
                        < best.end - best.start):
                    best = iv
            return best

        sp = inner(self.spans)
        op = inner(self.host)
        where = sp.name if sp is not None else "host"
        what = op.name if op is not None else "between_calls"
        return f"{where} / {what}"


def analyse(events) -> Trace:
    """A Trace from the profiler's raw events."""
    spans, host, launches = [], [], {}
    kernels_raw, copies = [], []
    window = None
    for e in events:
        name = e.name()
        iv = Interval(e.start_ns(), e.start_ns() + e.duration_ns(), name)
        if str(e.device_type()).endswith("CUDA"):
            if e.is_user_annotation():
                continue
            if _is_copy(name):
                copies.append(iv)
            else:
                kernels_raw.append((iv, e.correlation_id(),
                                    e.linked_correlation_id()))
            continue
        if name == PREFIX + "window":
            window = (iv.start, iv.end)
        if name.startswith(PREFIX):
            spans.append(iv)
            continue
        host.append(iv)
        if name in _LAUNCH:
            launches[e.correlation_id()] = iv.start
    if window is None:
        raise RuntimeError("the trace holds no port_bench.window range")
    # the harness's span around each launch: the innermost one open at
    # the launch call
    ordered = sorted((s for s in spans if s.name != PREFIX + "window"),
                     key=lambda s: s.start)

    def span_of(t: Optional[int]) -> Optional[str]:
        if t is None:
            return None
        best = None
        for s in ordered:
            if s.start > t:
                break
            if t < s.end and (best is None
                              or s.end - s.start < best.end - best.start):
                best = s
        return best.name if best is not None else None

    kernels = []
    for iv, corr, linked in kernels_raw:
        t = launches.get(corr, launches.get(linked))
        kernels.append((iv, span_of(t)))
    return Trace(window=window, kernels=kernels, copies=copies, host=host,
                 spans=spans)
