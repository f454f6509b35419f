"""Port vs JAX: `profiling.py` — StepTimer's summary on the same injected
clock, and trace() writing a torch.profiler trace that Chrome and
TensorBoard open."""

import glob
import json
import os

import pytest
import torch

from texir_code_tpu import profiling as JP
from texir_code_tpu_torch import profiling as TP

torch.set_num_threads(2)  # six test workers share the host's cores


class _Clock:
    """perf_counter replaced by a clock that ticks through given steps."""

    def __init__(self, steps):
        self.t = 0.0
        self.steps = iter(steps)
        self.start = True

    def __call__(self):
        if not self.start:
            self.t += next(self.steps)
        self.start = not self.start
        return self.t


@pytest.mark.parametrize("work", [{}, {"rays": 1_570_000.0, "texels": 8.0}])
def test_step_timer_summary_matches_jax(monkeypatch, work):
    steps = [0.012, 0.0105, 0.031, 0.0099, 0.0121]
    out = []
    for mod in (JP, TP):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(steps))
        timer = mod.StepTimer()
        assert timer.summary() == {}
        for _ in steps:
            with timer.measure(**work):
                pass
        out.append(timer.summary())
    assert out[0] == out[1]
    assert out[1]["steps"] == len(steps)
    assert ("Mrays_per_s" in out[1]) == bool(work)


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "tb")
    with TP.trace(logdir) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
