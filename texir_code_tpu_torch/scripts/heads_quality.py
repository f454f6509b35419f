"""Converged-quality runs of the port's three baseline heads.

    python -m texir_code_tpu_torch.scripts.heads_quality
        [--heads invrender,neilf,recmlp] [--max-epochs N] [--eval-spp 256]
        [--out FILE] [--data DIR] [--init-seed S] [--device cuda|cpu]

Run it from the root of a checkout.  It follows the JAX package's
`scripts/heads_quality.py`: each head (InvRender, NeILF, nvdiffrec) trains
on the quality run's material-consistent apartment at its reference
schedule (configs/reference/syn_{invrender,neilf,rec}.conf: 100, 50 and
100 epochs), then `BaselineHeadSynRunner.evaluate` scores it at
`--eval-spp` specular samples: the re-render metrics over the training
views, the held-out novel view's, and the GT albedo / roughness metrics.

The dataset is `texir_code_tpu_torch/scripts/quality_run.py`'s
(`<root>/demo_data/port_quality`, or `--data`): when it is absent this
script exports it and bakes its IrrT (--irt_res 512) by that script's own
steps.  Runs go to `<root>/exps/MatInvSyn-quality/...` and the like.
After each head the per-head table (the metrics, the stage's wall seconds
with set-up, the step and evaluation seconds, the peak device memory, the
device) is written to `--out` as JSON; the last line printed is the same
object.  `--init-seed` draws the networks' initial weights from another
seed (the spread of a head's metrics over its initialisations).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.getcwd()
CONF_OF_HEAD = {
    "invrender": "configs/reference/syn_invrender.conf",
    "neilf": "configs/reference/syn_neilf.conf",
    "recmlp": "configs/reference/syn_rec.conf",
}


def ensure_dataset(data: str, device: str) -> str:
    """The quality dataset's mesh path, exported and baked if absent."""
    from texir_code_tpu_torch.scripts import quality_run

    path_mesh = os.path.join(data, "mesh", "out1.obj")
    if not os.path.exists(path_mesh):
        path_mesh = quality_run.export_dataset(data, device)
    if not os.path.exists(path_mesh.replace("out1.obj", "irt.hdr")):
        quality_run.run_stage("IrrT", "configs/irt_synthetic.conf",
                              path_mesh, device, ["--irt_res", "512"])
    return path_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", default="invrender,neilf,recmlp")
    ap.add_argument("--max-epochs", type=int, default=None,
                    help="cap the epochs (default: each conf's reference "
                         "schedule)")
    ap.add_argument("--eval-spp", type=int, default=256)
    ap.add_argument("--out", default=os.path.join(ROOT, "exps",
                                                  "heads_quality.json"))
    ap.add_argument("--data", default=os.path.join(ROOT, "demo_data",
                                                   "port_quality"))
    ap.add_argument("--expname", default="quality")
    ap.add_argument("--init-seed", type=int, default=None,
                    help="draw the networks' initial weights from this "
                         "seed (default: the runners' own, 666)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from texir_code_tpu_torch.config import parse_file
    from texir_code_tpu_torch.train.heads import BaselineHeadSynRunner

    if args.device.startswith("cuda"):
        # full fp32, as the CLI runs (the SSIM blur needs it)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    path_mesh = ensure_dataset(args.data, args.device)
    print(f"dataset ready in {time.time() - t0:.1f} s: {path_mesh}",
          flush=True)
    device = (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
              else "cpu")
    results = {}
    for head in [h.strip() for h in args.heads.split(",") if h.strip()]:
        conf_path = CONF_OF_HEAD[head]
        conf = parse_file(conf_path)
        conf.put("train.path_mesh_open3d", path_mesh)
        t0 = time.time()
        runner = BaselineHeadSynRunner(
            conf, head, expname=args.expname, exps_root="exps",
            conf_path=conf_path, max_epochs=args.max_epochs,
            eval_spp=args.eval_spp, device=args.device)
        if args.init_seed is not None:  # in place: Adam holds the tensors
            gen = torch.Generator().manual_seed(args.init_seed)
            runner.params.load_state_dict(
                runner.model.init_params(gen).state_dict())
        runner.run()
        tm = runner.timings
        results[head] = dict(
            runner.metrics, wall_s=time.time() - t0, epochs=runner.nepochs,
            steps=tm["steps"], step_s=tm["step_s"],
            ms_per_step=tm["ms_per_step"], eval_s=tm["eval_s"],
            setup_s=tm["setup_s"],
            max_memory_allocated=tm.get("max_memory_allocated"),
            init_seed=args.init_seed, device=device)
        print(f"== {head} done in {results[head]['wall_s']:.1f} s: "
              f"{runner.metrics}", flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        del runner
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
