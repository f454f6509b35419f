"""Experiment directory layout and the global seed.

Reproduces the reference's exp management (trainer/train_material.py:62-94):

    <exps_root>/<Stage>-<expname>/<timestamp>/
        plots/
        checkpoints/ModelParameters/
        runconf.conf                           (config snapshot)
        scalars.tsv                            (ExperimentDir.writer())

plus `--is_continue [--timestamp]` resume discovery (exp_runner.py:37-42) and
the global seed (666, train_material.py:87-89).
"""

from __future__ import annotations

import datetime
import os
import random
import shutil
from typing import Optional

import numpy as np
import torch


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
        if is_continue:
            if timestamp in (None, "latest"):
                stamps = sorted(os.listdir(self.base)) if os.path.isdir(self.base) else []
                if not stamps:
                    raise FileNotFoundError(f"nothing to continue in {self.base}")
                timestamp = stamps[-1]
            self.timestamp = timestamp
            self.continued = True
        else:
            self.timestamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
            self.continued = False

        self.root = os.path.join(self.base, self.timestamp)
        self.plots_dir = os.path.join(self.root, "plots")
        self.checkpoints_dir = os.path.join(self.root, "checkpoints", "ModelParameters")
        os.makedirs(self.plots_dir, exist_ok=True)
        os.makedirs(self.checkpoints_dir, exist_ok=True)
        if conf_path and os.path.exists(conf_path):
            shutil.copy(conf_path, os.path.join(self.root, "runconf.conf"))

    def writer(self) -> "ScalarWriter":
        """Scalar log of the run (the reference's tensorboardX writer,
        :81-82): one `tag<TAB>step<TAB>value` line per scalar in
        <root>/scalars.tsv.  Close it when the run ends."""
        return ScalarWriter(os.path.join(self.root, "scalars.tsv"))


class ScalarWriter:
    """Appends scalars to a tab-separated text file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(f"{tag}\t{int(step)}\t{float(value)!r}\n")

    def close(self) -> None:
        self._f.close()


def seed_everything(seed: int = 666) -> torch.Generator:
    """Seed numpy, `random` and torch's default generator with `seed` (the
    reference seeds all three with 666) and return a CPU `torch.Generator`
    seeded alike, which the stages thread through explicitly."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
