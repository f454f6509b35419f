"""The benchmark's cells at a size a CPU test run holds: a checkout root
in a temporary directory whose configuration files are the real ones
(limits included) with the scenes and stage sizes cut down, and whose
traffic mixes and metric readers are the real files."""

from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CUTS = {
    "apartment": {
        "scene": {"generator": "apartment", "atlas_res": 32, "subdiv": 2},
        "bake": {"atlas_res": 48, "spp": 64, "texel_batch": 256},
    },
    "building": {
        "scene": {"generator": "building", "rooms": [2, 2], "atlas_res": 32,
                  "subdiv": 3},
        "bake": {"atlas_res": 48, "spp": 64, "texel_batch": 256},
        "mat": {"pano_res": [32, 64], "sample_light": [32, 4],
                "albedo_res": 64, "roughness_res": 128, "irt_res": 48,
                "cameras": [[2.5, 1.5, 2.5], [7.5, 1.5, 2.5],
                            [2.5, 1.5, 7.5], [7.5, 1.5, 7.5]]},
    },
}


# the Mat cell, held back from BENCHMARK.json until the card paces its
# step (PERF.md §4), with its metrics
MAT_CELL = {"name": "building-mat", "config": "building", "traffic": "mat",
            "chips": 1}
MAT_E2E = {"name": "mat_steps_per_s", "unit": "steps/s", "better": "higher",
           "bound": 0.1, "source": "host_clock",
           "workloads": ["building-mat"]}
MAT_METRICS = ("launches.mat", "mat_step_p95_ms", "enqueue_ms.mat",
               "cull_ms.mat", "walk_ms.mat", "walk_roofline.mat",
               "sampler_bwd_ms.mat", "optim_ms.mat", "idle_pct.mat")


def with_mat_cell(bench: dict) -> dict:
    """BENCHMARK.json with the Mat cell and its metrics added."""
    from port_bench import spec

    if MAT_CELL["name"] in {w["name"] for w in bench["workloads"]}:
        return bench
    bench["workloads"].append(dict(MAT_CELL))
    bench["end_to_end"].append(dict(MAT_E2E))
    for name in MAT_METRICS:
        r = spec.reader(name)
        bench["per_layer"].append({"name": name, "unit": r.UNIT,
                                   "moves": r.MOVES,
                                   "workloads": [MAT_CELL["name"]]})
    for m in bench["per_layer"]:
        if m["name"] == "pack_s":
            m["workloads"].append(MAT_CELL["name"])
    return bench


def make_root(tmp) -> tuple:
    """(root, bench): a tiny checkout under `tmp` and its BENCHMARK.json
    as a dict, with the Mat cell."""
    root = str(tmp)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = with_mat_cell(json.load(f))
    for sub in ("traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "port_bench", sub),
                        os.path.join(root, "port_bench", sub),
                        dirs_exist_ok=True)
    os.makedirs(os.path.join(root, "port_bench", "configs"), exist_ok=True)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        for key, cut in CUTS[c["name"]].items():
            if key == "scene":
                cfg["scene"] = dict(cut)
            elif key in cfg:
                cfg[key].update(cut)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    return root, bench


def run(root, bench, cell, seed=7, seconds=0.3, trace=False, check=None):
    """run_cell on the CPU."""
    import time

    import torch

    from port_bench import run as run_mod

    return run_mod.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.time(), check=check, bench=bench,
                            root=root)
