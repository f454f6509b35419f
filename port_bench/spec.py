"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic mix and its metrics, found by name.

    configs:   the file each `configs` entry names (configs/<name>.json)
    traffic:   traffic/<traffic>.json
    per-layer: metrics/<name>.py, a reader with UNIT, MOVES and read()

A new cell, configuration, mix or metric is a new file and a new entry in
BENCHMARK.json; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(path: Optional[str] = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        """What the traffic drives: "bake" or "mat"."""
        return self.traffic["kind"]


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: Optional[dict] = None,
         root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    bench = bench if bench is not None else load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(root, "port_bench", "traffic",
                                      f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer)


_readers: Dict[str, object] = {}


def reader(name: str, root: str = ROOT):
    """The module metrics/<name>.py (UNIT, MOVES, read(readings))."""
    path = os.path.join(root, "port_bench", "metrics", f"{name}.py")
    mod = _readers.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "port_bench.metrics." + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[path] = mod
    return mod
