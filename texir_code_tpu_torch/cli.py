"""Command-line entry point of the port — the exp_runner equivalent.

Train (reference trainer/exp_runner.py):
    python -m texir_code_tpu_torch.cli train --conf configs/x.conf \
        --trainstage {IrrT,Mat} [--irt_res 1024] [--max_epochs E] \
        [--is_continue [--timestamp T]] [--set KEY=VAL ...] \
        [--device cuda|cpu]

Demo (no dataset needed — exports a synthetic scan):
    python -m texir_code_tpu_torch.cli demo --out /tmp/demo [--device cpu]

Stages of the JAX CLI that are not ported yet exit with an error naming
the ROADMAP.md item that will port them.  The CLI runs float32 matrix
products and convolutions in full fp32 on the card (TF32 off): the SSIM
blur of the re-render metrics cancels catastrophically at lower precision.
"""

from __future__ import annotations

import argparse
import sys

import torch

from texir_code_tpu_torch.config import _parse_value, parse_file

# stages of the JAX CLI that are not ported yet → their ROADMAP.md item
_NOT_PORTED = {
    "MatSyn": "queue A item 9 (the synthetic-GT Mat runner, "
              "train/material_syn.py)",
    "IRRF": "queue A item 13 (fields + field stages)",
    "IRF": "queue A item 13 (fields + field stages)",
    "PIL": "queue A item 13 (fields + field stages)",
}
_HEADS = (
    "MatInv", "Inv", "MatNeilf", "Neilf", "MatRec", "RecMLP",
    "MatInvSyn", "InvSyn", "MatNeilfSyn", "NeilfSyn", "MatRecSyn",
    "RecMLPSyn",
)
_NOT_PORTED.update({h: "queue A item 14 (baseline heads)" for h in _HEADS})


def _irrt(conf, args):
    from texir_code_tpu_torch.train.irt import IrrTextureRunner

    return IrrTextureRunner(
        conf, expname=args.expname, exps_root=args.exps_folder,
        is_continue=args.is_continue, timestamp=args.timestamp,
        conf_path=args.conf, texture_res=args.irt_res, device=args.device,
    ).run()


def _mat(conf, args):
    from texir_code_tpu_torch.train.material import MatTrainRunner

    return MatTrainRunner(
        conf, expname=args.expname, exps_root=args.exps_folder,
        is_continue=args.is_continue, timestamp=args.timestamp,
        conf_path=args.conf, max_epochs=args.max_epochs, device=args.device,
    ).run()


TRAIN_STAGES = {"IrrT": _irrt, "Mat": _mat}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="texir_code_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    pt = sub.add_parser("train")
    pt.add_argument("--conf", required=True)
    pt.add_argument("--expname", default="default")
    pt.add_argument("--trainstage", required=True)
    pt.add_argument("--exps_folder", default="exps")
    pt.add_argument("--is_continue", action="store_true")
    pt.add_argument("--timestamp", default="latest")
    pt.add_argument("--max_epochs", type=int, default=None)
    pt.add_argument("--irt_res", type=int, default=1024)
    pt.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    dest="overrides",
                    help="conf override (repeatable), e.g. "
                         "--set train.path_mesh_open3d=./data/mesh/out1.obj")
    pt.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")

    pd = sub.add_parser("demo")
    pd.add_argument("--out", required=True)
    pd.add_argument("--views", type=int, default=4)
    pd.add_argument("--atlas_res", type=int, default=96)
    pd.add_argument("--device", default="cuda")

    args = parser.parse_args(argv)
    if args.device.startswith("cuda"):
        # full fp32 on the card (cuDNN convolutions default to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if args.command == "demo":
        from texir_code_tpu_torch.data.export import export_reference_layout
        from texir_code_tpu_torch.data.synthetic import make_scene

        scene = make_scene(atlas_res=args.atlas_res)
        path_mesh = export_reference_layout(scene, args.out,
                                            n_views=args.views,
                                            device=args.device)
        print(f"synthetic dataset exported; path_mesh_open3d = {path_mesh}")
        return 0

    stage = TRAIN_STAGES.get(args.trainstage)
    if stage is None:
        item = _NOT_PORTED.get(args.trainstage)
        if item is None:
            raise SystemExit(f"unknown train stage {args.trainstage!r}")
        raise SystemExit(
            f"train stage {args.trainstage!r} is not ported to "
            f"texir_code_tpu_torch yet: ROADMAP.md {item}"
        )
    conf = parse_file(args.conf)
    for kv in args.overrides:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VAL, got {kv!r}")
        conf.put(key.strip(), _parse_value(val.strip()))
    stage(conf, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
