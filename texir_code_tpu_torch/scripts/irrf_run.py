"""A longer NIrF run on the card: `train --trainstage IRRF` at the full
width of configs/irrf_synthetic.conf on the bench apartment, with the
validation every few epochs.

    python -m texir_code_tpu_torch.scripts.irrf_run [--epochs 100]
        [--val-every 10] [--summary out.json]

It exports the bench apartment afresh (`make_apartment_scene(atlas_res=
256, subdiv=24)`, 4 views at 256×512, as chip_smoke.py does) under
`demo_data/port_irrf`, trains `--epochs` epochs of samples_point_mesh /
batch_size steps (the runner trains `--max_epochs` + 1 epochs, so it
passes `--epochs` - 1), validates on the conf's val pano every
`--val-every` epochs (the GT traced once), and prints, last, one JSON
object: the card's name and power limit, the seconds an epoch, val_psnr /
val_ssim by epoch, and the conf's irf_epoch + 1 epochs projected at that
rate.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time


def main(argv=None):
    import torch

    from texir_code_tpu_torch import cli
    from texir_code_tpu_torch.config import parse_file
    from texir_code_tpu_torch.data.export import export_reference_layout
    from texir_code_tpu_torch.data.synthetic import make_apartment_scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--val-every", type=int, default=10)
    ap.add_argument("--summary", default=None)
    args = ap.parse_args(argv)
    root = os.path.join(os.getcwd(), "demo_data", "port_irrf")
    path_mesh = os.path.join(root, "mesh", "out1.obj")
    shutil.rmtree(root, ignore_errors=True)
    export_reference_layout(make_apartment_scene(atlas_res=256, subdiv=24),
                            root, n_views=4, pano_res=(256, 512),
                            device="cuda")
    here = os.path.dirname(os.path.abspath(cli.__file__))
    conf = os.path.join(os.path.dirname(here), "configs",
                        "irrf_synthetic.conf")
    c = parse_file(conf)
    steps_per_epoch = max(1, c.get_int("train.samples_point_mesh",
                                       default=1024)
                          // c.get_int("train.batch_size", default=16))
    conf_epochs = c.get_int("train.irf_epoch", default=4000) + 1  # 0..E
    exps = os.path.join(os.getcwd(), "exps", "port_irrf")
    t0 = time.time()
    cli.main(["train", "--conf", conf, "--trainstage", "IRRF",
              "--max_epochs", str(args.epochs - 1), "--exps_folder", exps,
              "--set", f"train.path_mesh_open3d={path_mesh}",
              "--set", f"train.plot_freq={args.val_every * steps_per_epoch}"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    runs = sorted(os.listdir(os.path.join(exps, "IRRF-default")))
    run = os.path.join(exps, "IRRF-default", runs[-1])
    with open(os.path.join(run, "timings.json")) as f:
        tm = json.load(f)
    val = {}
    with open(os.path.join(run, "scalars.tsv")) as f:
        for line in f:
            tag, step, value = line.rstrip("\n").split("\t")
            if tag in ("val_psnr", "val_ssim"):
                val.setdefault(int(step), {})[tag] = float(value)
    epochs = tm["steps"] // steps_per_epoch
    s_epoch = tm["train_s"] / epochs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    out = dict(
        card=smi, epochs=epochs, steps=tm["steps"], wall_s=wall,
        setup_s=tm["setup_s"], train_s=tm["train_s"],
        s_per_epoch=s_epoch, ms_per_step=tm["ms_per_step"],
        val_dataset_s=tm.get("val_dataset_s"), val_gt_s=tm.get("val_gt_s"),
        val_s=tm.get("val_s"), val_by_epoch=val,
        conf_epochs=conf_epochs, conf_epochs_projected_s=conf_epochs * s_epoch,
    )
    print(json.dumps(out), flush=True)
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
