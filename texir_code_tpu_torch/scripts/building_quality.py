"""Scan-scale quality run of the port: the 3x3-room building end to end.

    python -m texir_code_tpu_torch.scripts.building_quality [--skip-export]
        [--irrf-epochs 60] [--mat-epochs E] [--stages IRRF,IrrT,MatSyn]
        [--device cuda|cpu] [--data DIR] [--exps DIR] [--summary FILE]

Run it from the root of a checkout.  It follows the JAX package's
`scripts/building_quality.py` recipe through the port's CLI:

  1. export `make_building_scene(atlas_res=256, subdiv=28)` (104,076
     triangles, the bench's big scene) in the reference's dataset layout
     with the roomseg occupancy-grid assets, one camera a room centre plus
     a held-out novel view (info/novel.txt), material-rendered GT photos at
     256x512 (gt_spp 512, irt_spp 1024);
  2. `train --trainstage IRRF` (configs/irrf_synthetic.conf, --max_epochs
     60: capped, since the Mat metrics read the IrT, not the field; its
     val_psnr is recorded);
  3. `train --trainstage IrrT` at --irt_res 512 with the big scene's
     kernel shape (fan block 16, exit rows 8, two-pass 0.25, occluders);
  4. `train --trainstage MatSyn` (configs/mat_synthetic.conf; 40 epochs a
     substage unless --mat-epochs caps them).

This is the one run of the mode-2 (room x class) seg prior with more than
one room: the script fails unless the MatSyn log shows `roomseg active:
n_rooms=` above 1.  The stages run with TEXIR_PRINT_MEMORY set, so on the
card each reports its device memory high-water.  The dataset goes to
`<root>/demo_data_big` (or --data), the experiments to `<root>/exps` (or
--exps), both git-ignored.  The last line printed is one JSON object: the
four quality metrics (re-render, novel-view, mapped-texel albedo and
roughness PSNR), n_rooms, IRRF's val_psnr, the Mat step ms of each
substage, and each stage's seconds and peak MiB; --summary also writes it
to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import time
from typing import Tuple

import numpy as np

ROOT = os.getcwd()
EXPNAME = "building"
ROOM_SIZE = (5.0, 3.0, 5.0)


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The run's scene and stage settings (the JAX recipe's; the CPU test
    passes a tiny one)."""

    scene_kw: dict = dataclasses.field(
        default_factory=lambda: dict(atlas_res=256, subdiv=28))
    rooms: Tuple[int, int] = (3, 3)
    pano_res: Tuple[int, int] = (256, 512)
    gt_spp: int = 512
    irt_spp: int = 1024
    irt_res: int = 512
    irrf_sets: Tuple[str, ...] = ()
    irrt_sets: Tuple[str, ...] = ("train.bake_fan_block=16",
                                  "train.bake_exit_rows=8",
                                  "train.two_pass_cut=0.25")
    mat_sets: Tuple[str, ...] = ()


def building_cameras(rooms: Tuple[int, int] = (3, 3)) -> np.ndarray:
    """One camera a room centre (every room photographed, every room id
    exercised by the mode-2 prior), then one offset novel view."""
    cams = [[(i + 0.5) * ROOM_SIZE[0], 1.5, (j + 0.5) * ROOM_SIZE[2]]
            for j in range(rooms[1]) for i in range(rooms[0])]
    cams.append([1.2 * ROOM_SIZE[0], 1.6, 1.35 * ROOM_SIZE[2]])  # novel
    return np.asarray(cams, np.float32)


def export_dataset(data: str, recipe: Recipe, device: str) -> str:
    from texir_code_tpu_torch.data.export import export_reference_layout
    from texir_code_tpu_torch.data.synthetic import make_building_scene

    scene = make_building_scene(rooms=recipe.rooms, **recipe.scene_kw)
    print(f"building mesh: {scene.mesh.num_faces} triangles", flush=True)
    cams = building_cameras(recipe.rooms)
    path_mesh = export_reference_layout(
        scene, data, pano_res=recipe.pano_res, gt_render="material",
        gt_spp=recipe.gt_spp, irt_spp=recipe.irt_spp, cameras=cams,
        device=device)
    with open(os.path.join(data, "info", "novel.txt"), "w") as f:
        f.write(f"view{len(cams) - 1:03d}\n")
    if not os.path.exists(os.path.join(data, "roomseg",
                                       "roomSegs_uchar_f0.png")):
        raise SystemExit("the export wrote no roomseg assets")
    print(f"dataset exported: {path_mesh}", flush=True)
    return path_mesh


def run_stage(stage, conf, path_mesh, args, extra=(), sets=()):
    """One `train` stage through the port's CLI in its own process, its
    output passed through: (seconds, the output's lines)."""
    cmd = [sys.executable, "-m", "texir_code_tpu_torch.cli", "train",
           "--conf", conf, "--expname", EXPNAME, "--trainstage", stage,
           "--device", args.device, "--exps_folder", args.exps,
           "--set", f"train.path_mesh_open3d={path_mesh}", *extra]
    for kv in sets:
        cmd += ["--set", kv]
    print(f"== {stage}: {' '.join(cmd)}", flush=True)
    env = dict(os.environ, TEXIR_PRINT_MEMORY="1")
    t0 = time.time()
    lines = []
    with subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                          text=True) as proc:
        for line in proc.stdout:
            print(line, end="", flush=True)
            lines.append(line)
    if proc.returncode:
        raise SystemExit(f"{stage} failed with exit code {proc.returncode}")
    dt = time.time() - t0
    print(f"== {stage} wall-clock: {dt:.0f}s", flush=True)
    return dt, lines


def _peak_mib(lines):
    """The stage's `device memory high-water: <N> MiB`, or None (CPU)."""
    for line in lines:
        m = re.match(r"device memory high-water: (\d+) MiB", line)
        if m:
            return int(m.group(1))
    return None


def _timings(exps, stage_dir):
    runs = sorted(glob.glob(os.path.join(exps, f"{stage_dir}-{EXPNAME}", "*",
                                         "timings.json")))
    with open(runs[-1]) as f:
        return json.load(f)


def main(argv=None, recipe: Recipe = Recipe()):
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-export", action="store_true",
                    help="reuse the dataset of an earlier run")
    ap.add_argument("--irrf-epochs", type=int, default=60)
    ap.add_argument("--mat-epochs", type=int, default=None,
                    help="cap each Mat substage's epochs (default: the "
                         "conf's 40)")
    ap.add_argument("--stages", default="IRRF,IrrT,MatSyn",
                    help="comma-separated subset of IRRF,IrrT,MatSyn (a "
                         "MatSyn-only rerun reuses the baked irt.hdr)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default=os.path.join(ROOT, "demo_data_big"))
    ap.add_argument("--exps", default=os.path.join(ROOT, "exps"))
    ap.add_argument("--summary", default=None,
                    help="also write the summary JSON to this file")
    args = ap.parse_args(argv)

    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    seconds, peak = {}, {}
    summary = {"irrf_epochs": args.irrf_epochs,
               "mat_epochs": args.mat_epochs or "conf",
               "seconds": seconds, "peak_mib": peak}
    path_mesh = os.path.join(args.data, "mesh", "out1.obj")
    if not args.skip_export:
        t0 = time.time()
        path_mesh = export_dataset(args.data, recipe, args.device)
        seconds["export"] = time.time() - t0

    def stage(name, conf, extra=(), sets=()):
        seconds[name], lines = run_stage(name, conf, path_mesh, args, extra,
                                         sets)
        peak[name] = _peak_mib(lines)
        return lines

    if "IRRF" in stages:
        stage("IRRF", "configs/irrf_synthetic.conf",
              ["--max_epochs", str(args.irrf_epochs)], recipe.irrf_sets)
        tm = _timings(args.exps, "IRRF")
        summary.update(irrf_val_psnr=tm["val_metrics"].get("val_psnr"),
                       irrf_ms_per_step=tm["ms_per_step"])
    if "IrrT" in stages:
        stage("IrrT", "configs/irt_synthetic.conf",
              ["--irt_res", str(recipe.irt_res)], recipe.irrt_sets)
    if "MatSyn" in stages:
        lines = stage("MatSyn", "configs/mat_synthetic.conf",
                      ["--max_epochs", str(args.mat_epochs)]
                      if args.mat_epochs else [], recipe.mat_sets)
        rooms = [int(m.group(1)) for m in
                 (re.search(r"roomseg active: n_rooms=(\d+)", ln)
                  for ln in lines) if m]
        if not rooms or max(rooms) <= 1:
            raise SystemExit("the MatSyn log shows no 'roomseg active: "
                             "n_rooms=' above 1")
        tm = _timings(args.exps, "Mat")
        summary.update(
            n_rooms=max(rooms),
            rerender_psnr=tm["metrics"]["psnr"],
            novel_psnr=tm["novel_metrics"].get("novel_psnr"),
            albedo_psnr_mapped=tm["material_metrics"].get(
                "albedo_psnr_mapped"),
            roughness_psnr_mapped=tm["material_metrics"].get(
                "roughness_psnr_mapped"),
            mat_step_ms={k: 1e3 * tm[k]["step_s"] / max(tm[k]["steps"], 1)
                         for k in ("substage0", "substage1", "substage2")},
            metrics=tm["metrics"], novel_metrics=tm["novel_metrics"],
            material_metrics=tm["material_metrics"],
        )
    print("building quality run complete", flush=True)
    line = json.dumps(summary)
    if args.summary:
        with open(args.summary, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
