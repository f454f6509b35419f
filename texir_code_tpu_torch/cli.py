"""Command-line entry point of the port — the exp_runner equivalent.

Train (reference trainer/exp_runner.py):
    python -m texir_code_tpu_torch.cli train --conf configs/x.conf \
        --trainstage {IrrT,Mat,MatSyn,IRRF,IRF,PIL,MatInv,...} \
        [--irt_res 1024] [--max_epochs E] [--is_continue [--timestamp T]] \
        [--set KEY=VAL ...] [--device cuda|cpu] \
        [--coordinator HOST:PORT --num_processes N --process_id I]

Several processes (parallel/, one rank per device): every rank runs the
same `train` command with its own --process_id; `--device cuda` is then
this rank's card (cuda:(rank % device count)).  NCCL joins ranks that
have a card each, gloo the CPU and ranks that share a card; the group is
destroyed when the stage ends.  IrrT splits its texel batches, Mat /
MatSyn their pixels (or, with train.atlas_tp, their atlas rows) and the
field stages their GT traces over the ranks; rank 0 writes the files.

Test (reference tester/exp_runner.py):
    python -m texir_code_tpu_torch.cli test --conf configs/x.conf \
        --teststage {Editing,View,Relighting,Error} [--expname N] \
        [--timestamp T] [--exps_folder D] [--num_frames 60] \
        [--relight_mode emitter|pathtrace] [--set KEY=VAL ...] \
        [--device cuda|cpu]

Demo (no dataset needed — exports a synthetic scan):
    python -m texir_code_tpu_torch.cli demo --out /tmp/demo [--device cpu]

The reference enables torch's anomaly detection globally (exp_runner.py:
24); `--debug_nans` on train and test turns it on here.  With
TEXIR_PRINT_MEMORY set in the environment, a stage on the card ends by
printing the device memory high-water (`torch.cuda.max_memory_allocated`).

The train stages: IrrT (the irradiance-texture bake), Mat and MatSyn (the
SVBRDF atlases; MatSyn adds the GT-material and novel-view metrics), the
field stages IRRF (the neural irradiance field, NIrF), IRF (the
view-dependent incident-radiance field) and PIL (the pre-integrated
lighting field), and the baseline heads MatInv / MatNeilf / MatRec
(InvRender, NeILF, nvdiffrec; also Inv / Neilf / RecMLP) and their
synthetic-GT forms MatInvSyn / MatNeilfSyn / MatRecSyn (InvSyn / NeilfSyn
/ RecMLPSyn), which evaluate at 256 specular samples.  The CLI runs
float32 matrix products and convolutions in full fp32 on the card (TF32
off): the SSIM blur of the re-render metrics cancels catastrophically at
lower precision, and the field MLPs stay in fp32 as in the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from texir_code_tpu_torch.config import _parse_value, parse_file

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


def _mat_syn(conf, args):
    from texir_code_tpu_torch.train.material_syn import MatTrainSynRunner

    return MatTrainSynRunner(
        conf, expname=args.expname, exps_root=args.exps_folder,
        is_continue=args.is_continue, timestamp=args.timestamp,
        conf_path=args.conf, max_epochs=args.max_epochs, device=args.device,
    ).run()


def _field_stage(conf, args):
    from texir_code_tpu_torch.train.irf_pil import (
        IRFTrainRunner,
        PILTrainRunner,
    )
    from texir_code_tpu_torch.train.irrf import IRRFTrainRunner

    cls = {"IRRF": IRRFTrainRunner, "IRF": IRFTrainRunner,
           "PIL": PILTrainRunner}[args.trainstage]
    return cls(
        conf, expname=args.expname, exps_root=args.exps_folder,
        is_continue=args.is_continue, timestamp=args.timestamp,
        conf_path=args.conf, max_epochs=args.max_epochs, device=args.device,
    ).run()


# the baseline heads: this CLI's names and the reference exp_runner's
# (trainer/exp_runner.py:55-66), as the JAX CLI maps them
_HEAD_OF_STAGE = {
    "MatInv": "invrender", "Inv": "invrender",
    "MatNeilf": "neilf", "Neilf": "neilf",
    "MatRec": "recmlp", "RecMLP": "recmlp",
}
_SYN_HEAD_OF_STAGE = {
    "MatInvSyn": "invrender", "InvSyn": "invrender",
    "MatNeilfSyn": "neilf", "NeilfSyn": "neilf",
    "MatRecSyn": "recmlp", "RecMLPSyn": "recmlp",
}


def _head(conf, args):
    from texir_code_tpu_torch.train.heads import (
        BaselineHeadRunner,
        BaselineHeadSynRunner,
    )

    if args.trainstage in _SYN_HEAD_OF_STAGE:
        cls, head = BaselineHeadSynRunner, _SYN_HEAD_OF_STAGE[args.trainstage]
    else:
        cls, head = BaselineHeadRunner, _HEAD_OF_STAGE[args.trainstage]
    return cls(conf, head, expname=args.expname, exps_root=args.exps_folder,
               conf_path=args.conf, max_epochs=args.max_epochs,
               device=args.device).run()


TRAIN_STAGES = {"IrrT": _irrt, "Mat": _mat, "MatSyn": _mat_syn,
                "IRRF": _field_stage, "IRF": _field_stage,
                "PIL": _field_stage,
                **{name: _head for name in (*_HEAD_OF_STAGE,
                                            *_SYN_HEAD_OF_STAGE)}}


def _tester(cls, conf, args):
    return cls(conf, expname=args.expname, exps_root=args.exps_folder,
               timestamp=args.timestamp, device=args.device)


def _editing(conf, args):
    from texir_code_tpu_torch.eval.runners import MatEditingRunner

    return _tester(MatEditingRunner, conf, args).run_from_conf()


def _view(conf, args):
    from texir_code_tpu_torch.eval.runners import NovelViewRunner

    return _tester(NovelViewRunner, conf, args).run(num=args.num_frames)


def _relighting(conf, args):
    from texir_code_tpu_torch.eval.runners import RelightingRunner

    return _tester(RelightingRunner, conf, args).run(mode=args.relight_mode)


def _error(conf, args):
    from texir_code_tpu_torch.eval.runners import MatErrorRunner

    return _tester(MatErrorRunner, conf, args).run()


TEST_STAGES = {"Editing": _editing, "View": _view,
               "Relighting": _relighting, "Error": _error}


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
    pt.add_argument("--debug_nans", action="store_true",
                    help="torch.autograd anomaly detection")
    # several processes: every rank runs the same command with its own
    # --process_id (parallel/multihost.py)
    pt.add_argument("--coordinator", default=None,
                    help="rank 0's rendezvous address host:port")
    pt.add_argument("--num_processes", type=int, default=None)
    pt.add_argument("--process_id", type=int, default=None)

    pe = sub.add_parser("test")
    pe.add_argument("--conf", required=True)
    pe.add_argument("--expname", default="default")
    pe.add_argument("--teststage", required=True, choices=sorted(TEST_STAGES))
    pe.add_argument("--exps_folder", default="exps")
    pe.add_argument("--timestamp", default="latest")
    pe.add_argument("--num_frames", type=int, default=60)
    pe.add_argument("--relight_mode", default="emitter",
                    choices=["emitter", "pathtrace"])
    pe.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    dest="overrides", help="conf override (repeatable)")
    pe.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    pe.add_argument("--debug_nans", action="store_true",
                    help="torch.autograd anomaly detection")

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

    if args.command == "test":
        stage = TEST_STAGES[args.teststage]
    else:
        stage = TRAIN_STAGES.get(args.trainstage)
        if stage is None:
            raise SystemExit(f"unknown train stage {args.trainstage!r}")
    multi = args.command == "train" and (args.coordinator
                                         or args.num_processes)
    if multi:
        import torch.distributed as dist

        from texir_code_tpu_torch.parallel.multihost import (
            initialize_multihost,
        )

        rank, world = initialize_multihost(
            args.coordinator, args.num_processes, args.process_id,
            device=args.device)
        backend = dist.get_backend() if dist.is_initialized() else "no group"
        print(f"multihost: process {rank}/{world} ({backend})", flush=True)
        if args.device == "cuda" and torch.cuda.is_available():
            args.device = f"cuda:{torch.cuda.current_device()}"
    try:
        conf = parse_file(args.conf)
        for kv in args.overrides:
            key, sep, val = kv.partition("=")
            if not sep:
                raise SystemExit(f"--set expects KEY=VAL, got {kv!r}")
            conf.put(key.strip(), _parse_value(val.strip()))
        with torch.autograd.set_detect_anomaly(args.debug_nans):
            stage(conf, args)
        if (os.environ.get("TEXIR_PRINT_MEMORY")
                and args.device.startswith("cuda")):
            peak = torch.cuda.max_memory_allocated()
            print(f"device memory high-water: {peak / 2**20:.0f} MiB")
    finally:
        if multi:
            from texir_code_tpu_torch.parallel.multihost import (
                shutdown_multihost,
            )

            shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main())
