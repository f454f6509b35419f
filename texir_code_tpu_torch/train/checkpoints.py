"""Checkpoint save/restore with torch.save (the JAX package uses orbax).

A checkpoint is one file `step_<8 digits>.pt` holding a dict of tensors
(and of state dicts: a network's, an optimizer's), and a `LATEST` marker
names the newest, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_cpu(v):
    """A state dict with its tensors on the CPU (other leaves as they are)."""
    if torch.is_tensor(v):
        return v.detach().cpu()
    if isinstance(v, dict):
        return {k: _to_cpu(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_cpu(x) for x in v)
    return v


def save_checkpoint(directory: str, step: int, payload: Dict[str, Any]) -> str:
    """Save a dict of arrays/tensors (moved to the CPU) and of state dicts
    (dict values, saved as they are with their tensors on the CPU) as step
    `step`."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}.pt")
    torch.save({k: _to_cpu(v) if isinstance(v, dict)
                else torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                     else v.detach().cpu())
                for k, v in payload.items()}, path)
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(os.path.basename(path))
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    marker = os.path.join(directory, "LATEST")
    if os.path.exists(marker):
        with open(marker) as f:
            return os.path.join(directory, f.read().strip())
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_")) if os.path.isdir(directory) else []
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(directory: str, template: Dict[str, Any]
                       ) -> Optional[Dict[str, torch.Tensor]]:
    """The latest checkpoint's entries named in `template` (CPU tensors of
    the template's shapes; state dicts where the template holds a dict);
    None if there is no checkpoint."""
    path = latest_checkpoint(directory)
    if path is None or not os.path.exists(path):
        return None
    data = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, ref in template.items():
        if isinstance(ref, dict):
            out[k] = data[k]
            continue
        if tuple(data[k].shape) != tuple(np.shape(ref)):
            raise ValueError(f"checkpoint {path}: {k} has shape "
                             f"{tuple(data[k].shape)}, expected {np.shape(ref)}")
        out[k] = data[k]
    return out
