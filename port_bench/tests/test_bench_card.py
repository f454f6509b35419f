"""One short run of each cell on the card, through the command the
driver runs (marked cuda: skips without a card)."""

import json
import subprocess
import sys

import pytest

from port_bench import spec
from port_bench.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_cell_runs_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         "3000000123", "--seconds", "2", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
