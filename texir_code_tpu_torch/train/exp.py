"""Experiment directory layout, the global seed and the stages' Adam.

Reproduces the reference's exp management (trainer/train_material.py:62-94):

    <exps_root>/<Stage>-<expname>/<timestamp>/
        plots/
        checkpoints/ModelParameters/
        runconf.conf                           (config snapshot)
        scalars.tsv                            (ExperimentDir.writer())

plus `--is_continue [--timestamp]` resume discovery (exp_runner.py:37-42) and
the global seed (666, train_material.py:87-89).

A run of several ranks (parallel/) makes one experiment directory: rank 0
picks the timestamp and broadcasts it, and only rank 0 (`is_writer()`)
makes the directories and writes images, atlases, scalars.tsv,
timings.json and checkpoints.  (The JAX package's processes write on
separate hosts.)
"""

from __future__ import annotations

import datetime
import os
import random
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def is_writer() -> bool:
    """True on the rank that writes the run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def agreed(value):
    """Rank 0's `value` on every rank (the value itself in one process)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    # NCCL stages the object on this rank's current card, gloo on the host
    dist.broadcast_object_list(box, 0)
    return box[0]


class ExperimentDir:
    def __init__(
        self,
        exps_root: str,
        stage: str,
        expname: str,
        is_continue: bool = False,
        timestamp: Optional[str] = None,
        conf_path: Optional[str] = None,
    ):
        self.base = os.path.join(exps_root, f"{stage}-{expname}")
        self.is_writer = is_writer()
        if is_continue:
            if timestamp in (None, "latest") and self.is_writer:
                stamps = sorted(os.listdir(self.base)) if os.path.isdir(self.base) else []
                timestamp = stamps[-1] if stamps else None
            timestamp = agreed(timestamp)
            if timestamp is None:
                raise FileNotFoundError(f"nothing to continue in {self.base}")
            self.timestamp = timestamp
            self.continued = True
        else:
            self.timestamp = agreed(
                datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S"))
            self.continued = False

        self.root = os.path.join(self.base, self.timestamp)
        self.plots_dir = os.path.join(self.root, "plots")
        self.checkpoints_dir = os.path.join(self.root, "checkpoints", "ModelParameters")
        if self.is_writer:
            os.makedirs(self.plots_dir, exist_ok=True)
            os.makedirs(self.checkpoints_dir, exist_ok=True)
            if conf_path and os.path.exists(conf_path):
                shutil.copy(conf_path, os.path.join(self.root, "runconf.conf"))

    def writer(self) -> "ScalarWriter":
        """Scalar log of the run (the reference's tensorboardX writer,
        :81-82): one `tag<TAB>step<TAB>value` line per scalar in
        <root>/scalars.tsv (on the writing rank; the others discard
        theirs).  Close it when the run ends."""
        if not self.is_writer:
            return ScalarWriter(None)
        return ScalarWriter(os.path.join(self.root, "scalars.tsv"))


class ScalarWriter:
    """Appends scalars to a tab-separated text file (path None: discards
    them)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = open(path, "a") if path is not None else None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._f is not None:
            self._f.write(f"{tag}\t{int(step)}\t{float(value)!r}\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


SEED = 666  # the reference's global seed


def draw_seed(n: int) -> int:
    """The draw seed of a runner's or tester's n-th keyed call.  The JAX
    package folds n into PRNGKey(666); the port hashes this seed with each
    row's global id (ops.sampling.hash_uniform)."""
    return (SEED << 24) + n


def seed_everything(seed: int = SEED) -> torch.Generator:
    """Seed numpy, `random` and torch's default generator with `seed` (the
    reference seeds all three with 666) and return a CPU `torch.Generator`
    seeded alike, which the stages thread through explicitly."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def adam_staircase(parameters, lr: float, sched_step: int, factor: float,
                   steps_per_epoch: int):
    """torch.optim.Adam over `parameters` with the JAX stages' staircase
    decay, `optax.exponential_decay(lr, transition_steps=sched_step ·
    steps_per_epoch, decay_rate=factor, staircase=True)` (the reference's
    StepLR counted in epochs): optimizer step k uses lr · factor^floor(k /
    (sched_step · steps_per_epoch)).  Returns (optimizer, scheduler); call
    scheduler.step() after each optimizer.step()."""
    opt = torch.optim.Adam(list(parameters), lr=lr)
    period = max(1, sched_step * steps_per_epoch)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda k: factor ** (k // period)
    )
    return opt, sched
