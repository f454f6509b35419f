"""Converged-quality run of the port: the synthetic apartment end to end.

    python -m texir_code_tpu_torch.scripts.quality_run [--mat-epochs E]
        [--stages IrrT,MatSyn] [--device cuda|cpu] [--data DIR]
        [--summary FILE]

Run it from the root of a checkout.  It follows the JAX package's
`scripts/quality_run.py` recipe through the port's CLI:

  1. export `make_apartment_scene(atlas_res=256, subdiv=24)` in the
     reference's dataset layout with material-rendered GT photos
     (`gt_render="material"`, 5 views at 256×512, gt_spp 512, irt_spp
     1024), holding `view004` out as the novel view (info/novel.txt);
  2. `train --trainstage IrrT` (configs/irt_synthetic.conf, --irt_res 512);
  3. `train --trainstage MatSyn` (configs/mat_synthetic.conf; 40 epochs a
     substage unless --mat-epochs caps them), which prints the re-render,
     material and novel-view metrics.

The Mat metrics do not read the IRRF field, so IRRF (not ported) is not a
stage here.  The dataset goes to `<root>/demo_data/port_quality` (or
`--data`) and the experiments to `<root>/exps/*-quality` (both
git-ignored).  The last line printed is one JSON object: the four quality
metrics (re-render PSNR, novel-view PSNR, mapped-texel albedo and
roughness PSNR), the epochs, and each step's seconds; `--summary` also
writes it to a file.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.getcwd()
EXPNAME = "quality"
MAT_CONF = "configs/mat_synthetic.conf"


def export_dataset(data: str, device: str) -> str:
    from texir_code_tpu_torch.data.export import export_reference_layout
    from texir_code_tpu_torch.data.synthetic import make_apartment_scene

    scene = make_apartment_scene(atlas_res=256, subdiv=24)
    # material-consistent GT photos: radiance panos are view-independent
    # and carry no roughness signal
    path_mesh = export_reference_layout(
        scene, data, n_views=5, pano_res=(256, 512), gt_render="material",
        gt_spp=512, irt_spp=1024, device=device)
    with open(os.path.join(data, "info", "novel.txt"), "w") as f:
        f.write("view004\n")
    tm = export_reference_layout.timings
    print(f"dataset exported: {path_mesh} (GT IrT bake {tm['bake_s']:.2f} s, "
          f"views {', '.join(f'{t:.2f}' for t in tm['views_s'])} s)",
          flush=True)
    return path_mesh


def run_stage(stage, conf, path_mesh, device, extra=()):
    cmd = [sys.executable, "-m", "texir_code_tpu_torch.cli", "train",
           "--conf", conf, "--expname", EXPNAME, "--trainstage", stage,
           "--device", device,
           "--set", f"train.path_mesh_open3d={path_mesh}", *extra]
    print(f"== {stage}: {' '.join(cmd)}", flush=True)
    t0 = time.time()
    subprocess.run(cmd, cwd=ROOT, check=True)
    return time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mat-epochs", type=int, default=None,
                    help="cap each Mat substage's epochs (default: the "
                         "conf's 40)")
    ap.add_argument("--stages", default="IrrT,MatSyn",
                    help="comma-separated subset of IrrT,MatSyn (a "
                         "MatSyn-only rerun reuses the baked irt.hdr)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default=os.path.join(ROOT, "demo_data",
                                                   "port_quality"))
    ap.add_argument("--summary", default=None,
                    help="also write the summary JSON to this file")
    args = ap.parse_args(argv)

    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    seconds = {}
    t0 = time.time()
    path_mesh = export_dataset(args.data, args.device)
    seconds["export"] = time.time() - t0
    mat_extra = (["--max_epochs", str(args.mat_epochs)]
                 if args.mat_epochs else [])
    if "IrrT" in stages:
        seconds["IrrT"] = run_stage("IrrT", "configs/irt_synthetic.conf",
                                    path_mesh, args.device,
                                    ["--irt_res", "512"])
    summary = {"epochs": args.mat_epochs or "conf", "seconds": seconds}
    if "MatSyn" in stages:
        seconds["MatSyn"] = run_stage("MatSyn", MAT_CONF, path_mesh,
                                      args.device, mat_extra)
        runs = sorted(glob.glob(os.path.join(
            ROOT, "exps", f"Mat-{EXPNAME}", "*", "timings.json")))
        with open(runs[-1]) as f:
            tm = json.load(f)
        summary.update(
            rerender_psnr=tm["metrics"]["psnr"],
            novel_psnr=tm["novel_metrics"].get("novel_psnr"),
            albedo_psnr_mapped=tm["material_metrics"].get(
                "albedo_psnr_mapped"),
            roughness_psnr_mapped=tm["material_metrics"].get(
                "roughness_psnr_mapped"),
            metrics=tm["metrics"], novel_metrics=tm["novel_metrics"],
            material_metrics=tm["material_metrics"],
        )
    print("quality run complete", flush=True)
    line = json.dumps(summary)
    if args.summary:
        with open(args.summary, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
