"""NeILF's quality run with its matrix products' operands rounded to bf16.

    python experiments/neilf_bf16.py [--out-dir DIR]   # a checkout's root

An experiment, not part of the port: it asks whether NeILF's quality gap to
the JAX package's TPU v5e table comes from the TPU's default precision, at
which a float32 matrix product runs as one bf16 pass.  It runs
`texir_code_tpu_torch.scripts.heads_quality --heads neilf` (the reference
schedule, 50 epochs) twice in one process: first as the port runs it (fp32
products, TF32 off), then with every `nn.Linear`'s operands (its input, its
weight and, in the backward, its incoming gradient) rounded to bf16 and the
products accumulated in fp32.  Each run's table goes to
<out-dir>/neilf_<mode>.json (default exps/neilf_bf16); the last line holds
both.
"""

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

_linear = F.linear


class RoundGrad(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to bf16
    (differentiably, so NeILF's double backward runs through it)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


def rb(t):
    """t rounded to bf16 in the forward, the gradient passed straight."""
    return t + (t.to(torch.bfloat16).to(torch.float32) - t).detach()


def linear_bf16(x, w, b=None):
    return RoundGrad.apply(_linear(rb(x), rb(w), b))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=os.path.join("exps", "neilf_bf16"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    from texir_code_tpu_torch.scripts import heads_quality

    out = {}
    try:
        for mode in ("fp32", "bf16"):
            # nn.Linear calls torch.nn.functional.linear at each forward
            F.linear = linear_bf16 if mode == "bf16" else _linear
            path = os.path.join(args.out_dir, f"neilf_{mode}.json")
            heads_quality.main(["--heads", "neilf", "--out", path,
                                "--expname", "q" + mode])
            with open(path) as f:
                out[mode] = json.load(f)["neilf"]
    finally:
        F.linear = _linear
    print("NEILF", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
