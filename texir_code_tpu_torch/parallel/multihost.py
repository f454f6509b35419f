"""Multi-process initialisation and process-local sharding helpers.

The port of the JAX package's `parallel/multihost.py` on torch.distributed.
In the port one rank is one device: every process runs the same program,
`initialize_multihost()` joins them into one process group, and the world
mesh (parallel.mesh) spans every rank.  The bake's host loop then feeds
each rank its contiguous share of texel batches (`process_local_slice`).

The backend follows where the ranks run: NCCL when each rank has a card of
its own, gloo on the CPU and when ranks share a card (NCCL refuses two
ranks on one device).  The work stays on the card either way; under gloo a
collective stages its tensor through host memory (parallel.mesh).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# a rank that dies leaves the others blocked at their next collective for
# at most this long
TIMEOUT_S = 600.0


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    LOCAL_RANK; the global rank when the launcher sets none: one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def pick_backend(num_processes: int, device="cuda") -> str:
    """'nccl' when the ranks run on cards and every rank of this host has
    one of its own, else 'gloo' (CPU ranks, or ranks that share a card).
    The ranks of this host: torchrun's LOCAL_WORLD_SIZE, else all of them
    (one host)."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> Tuple[int, int]:
    """Join the process group (nothing to do in a one-process run).

    Args:
        coordinator_address: "host:port" of rank 0's rendezvous.
        num_processes / process_id: the world size and this rank; given a
            coordinator without them, RANK / WORLD_SIZE from the
            environment (torchrun's counterpart of JAX's autodetect).
        backend: 'nccl' or 'gloo'; None picks one for `device`
            (pick_backend).
        device: where the ranks' work runs ('cuda' or 'cpu').
    Returns:
        (rank, world size).  On a host with cards, rank r's current CUDA
        device becomes cuda:(local rank % device count).
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and (num_processes or 1) <= 1:
        return 0, 1
    if coordinator_address is None:
        raise ValueError("initialize_multihost: num_processes > 1 needs a "
                         "coordinator address")
    if num_processes is None:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            raise ValueError("initialize_multihost: no num_processes and no "
                             "RANK / WORLD_SIZE in the environment")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if process_id is None:
        if num_processes != 1:
            raise ValueError("initialize_multihost: process_id is required")
        process_id = 0
    backend = backend or pick_backend(num_processes, device)
    if torch.cuda.is_available():
        torch.cuda.set_device(
            int(os.environ.get("LOCAL_RANK", process_id))
            % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    return dist.get_rank(), dist.get_world_size()


def shutdown_multihost() -> None:
    """Destroy the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_local_slice(n: int, process_index: int, process_count: int) -> slice:
    """Contiguous [start, stop) share of n items for this process."""
    per = (n + process_count - 1) // process_count
    start = process_index * per
    return slice(start, min(start + per, n))


def global_mesh(device=None):
    """The mesh over every rank of the world (parallel.mesh.DeviceMesh)."""
    from texir_code_tpu_torch.parallel.mesh import make_device_mesh

    return make_device_mesh(device=device)
