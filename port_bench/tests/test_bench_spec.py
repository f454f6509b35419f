"""The harness finds configurations, traffic mixes and metrics by name,
and a new cell is new files and entries, with no edit."""

import json
import os
import shutil

import pytest

from port_bench import spec
from port_bench.tests import tiny


def test_every_cell_resolves():
    bench = spec.load_benchmark()
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert cell.kind in ("bake", "mat")
        assert cell.kind in cell.config
        assert cell.chips == w["chips"]
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            r = spec.reader(m["name"])
            assert r.UNIT == m["unit"] and r.MOVES == m["moves"]
            assert m["moves"] in e2e


def test_metrics_and_files_match_benchmark():
    bench = spec.load_benchmark()
    files = {f[:-3] for f in os.listdir(os.path.join(spec.HERE, "metrics"))
             if f.endswith(".py")}
    assert {m["name"] for m in bench["per_layer"]} <= files
    for name in files:  # a reader waiting for its cell loads as well
        r = spec.reader(name)
        assert r.UNIT and r.MOVES and callable(r.read)
    for c in bench["configs"]:
        assert c["file"].startswith("port_bench/configs/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_a_new_cell_is_new_files(tmp_path):
    root, bench = tiny.make_root(tmp_path)
    cfgs = os.path.join(root, "port_bench", "configs")
    shutil.copy(os.path.join(cfgs, "apartment.json"),
                os.path.join(cfgs, "apartment_b.json"))
    with open(os.path.join(root, "port_bench", "traffic", "bake.json")) as f:
        traffic = json.load(f)
    traffic["check_texels"] = 5
    with open(os.path.join(root, "port_bench", "traffic",
                           "bake_small.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "port_bench", "metrics",
                           "texels_checked.bake.py"), "w") as f:
        f.write('UNIT = "texels"\nMOVES = "bake_mrays_per_s"\n\n\n'
                'def read(r):\n    return 5.0 if r.kind == "bake" else None\n')
    bench["configs"].append({"name": "apartment_b",
                             "file": "port_bench/configs/apartment_b.json"})
    bench["workloads"].append({"name": "apartment-b-bake",
                               "config": "apartment_b",
                               "traffic": "bake_small", "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "apartment-bake" in m["workloads"]:
            m["workloads"].append("apartment-b-bake")
    bench["per_layer"].append({"name": "texels_checked.bake",
                               "unit": "texels", "moves": "bake_mrays_per_s",
                               "workloads": ["apartment-b-bake"]})
    cell = spec.cell("apartment-b-bake", bench, root=root)
    assert cell.traffic["check_texels"] == 5
    out = tiny.run(root, bench, "apartment-b-bake", trace=True)
    assert out["metrics"]["texels_checked.bake"]["value"] == 5.0
    assert out["correct"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
