"""The shape of a run's last line, and the runs that must print none."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell,trace", [("apartment-bake", False),
                                        ("apartment-bake", True),
                                        ("building-bake", False),
                                        ("building-mat", False),
                                        ("building-mat", True)])
def test_last_line_shape(root, cell, trace):
    r, bench = root
    out = tiny.run(r, bench, cell, trace=trace)
    keys = list(out)
    assert keys[:5] == KEYS
    assert keys[-1] == "checks"
    assert keys[5:-1] == (["breakdown"] if trace else [])
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    dev = out["device"]
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in dev
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    wl = [w for w in bench["workloads"] if w["name"] == cell][0]
    allowed = {m["name"] for m in bench["per_layer" if trace
                                        else "end_to_end"]
               if "workloads" not in m or cell in m["workloads"]}
    assert set(out["metrics"]) <= allowed
    if not trace:
        assert "setup_s" in out["metrics"]
        assert len(out["metrics"]) >= 2
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)
    assert wl["chips"] == dev["count"]


def _run_cli(cwd):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "apartment-bake",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run_cli(tiny.ROOT)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(tiny.ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    p = _run_cli(tmp_path)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
