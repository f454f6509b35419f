"""Device mesh, shares and collectives over torch.distributed.

The port of the JAX package's `parallel/mesh.py`.  The JAX package shards
rays and texels over the chips of a `Mesh` inside one process; the port
runs one rank per device, so:

  * a `Mesh` becomes the process group (`DeviceMesh`: group, rank, size,
    device); without a group, `make_device_mesh` gives a one-rank mesh
    whose collectives are identities, as JAX's one-device mesh runs the
    sharded code with one shard;
  * `shard_map` over the ray or texel axis becomes each rank computing its
    contiguous share (`DeviceMesh.shares`), `psum` and `all_gather` become
    `all_reduce` and `all_gather`;
  * the collectives that carry a gradient are this module's own autograd
    functions: `psum_replicated` (a sum whose backward is the identity,
    because the cotangent of a replicated result is replicated) and
    `all_gather_rows` (a concatenation whose backward takes this rank's
    rows of the cotangent).  torch.distributed.nn's all_reduce would
    all-reduce the cotangent too and scale every gradient by the world
    size.

Under gloo a collective on a CUDA tensor stages it through host memory;
under NCCL it runs on the card.  `COUNTS` counts every collective and its
bytes (the dry run checks that the gradient all-reduce ran).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from texir_code_tpu_torch import profiling
from texir_code_tpu_torch.parallel.multihost import local_rank, process_local_slice

# calls and bytes of each collective (keys "<op>" and "<op>_bytes");
# callers reset it with .clear()
COUNTS: collections.Counter = profiling.counter("collectives")


def _count(op: str, t: torch.Tensor) -> None:
    COUNTS[op] += 1
    COUNTS[op + "_bytes"] += t.numel() * t.element_size()


@dataclasses.dataclass
class DeviceMesh:
    """One rank's view of a 1-D mesh: the process group (None for a
    one-rank mesh), this rank, the rank count and this rank's device."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def _staged(self, t: torch.Tensor) -> bool:
        return t.device.type == "cuda" and self.backend == "gloo"

    # -- shares ------------------------------------------------------------

    def share(self, n: int, unit: int = 1) -> slice:
        """This rank's contiguous block of n items, cut at multiples of
        `unit` (the last block may be short)."""
        return self.shares(n, unit)[self.rank]

    def shares(self, n: int, unit: int = 1) -> List[slice]:
        """Every rank's block of n items, cut at multiples of `unit`."""
        units = -(-n // unit)
        out = []
        for r in range(self.size):
            s = process_local_slice(units, r, self.size)
            out.append(slice(min(s.start * unit, n), min(s.stop * unit, n)))
        return out

    # -- collectives (no autograd) ---------------------------------------

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns t."""
        _count("all_reduce", t)
        if self.group is None:
            return t
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather_rows(self, t: torch.Tensor,
                        counts: Sequence[int]) -> torch.Tensor:
        """Concatenate every rank's rows (rank r holds counts[r] rows of
        dim 0, this rank's are `t`), in rank order."""
        _count("all_gather", t)
        if self.group is None:
            return t
        if t.shape[0] != counts[self.rank]:
            raise ValueError(f"all_gather_rows: rank {self.rank} holds "
                             f"{t.shape[0]} rows, expected {counts[self.rank]}")
        m = max(counts)
        src = t.cpu() if self._staged(t) else t
        if t.shape[0] < m:
            src = torch.cat([src, src.new_zeros((m - t.shape[0],)
                                                + tuple(t.shape[1:]))])
        bufs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(bufs, src.contiguous(), group=self.group)
        out = torch.cat([b[:c] for b, c in zip(bufs, counts)])
        return out.to(t.device)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `t` on every rank, in place; returns t."""
        _count("broadcast", t)
        if self.group is None:
            return t
        if self._staged(t):
            host = t.cpu()
            dist.broadcast(host, src, group=self.group)
            t.copy_(host)
        else:
            dist.broadcast(t, src, group=self.group)
        return t

    def all_reduce_grads(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum the .grad of each tensor over the ranks (the data-parallel
        step's gradient all-reduce); a missing grad counts as zeros."""
        for p in tensors:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self.all_reduce_(p.grad)

    def check_replicated(self, name: str, value: int) -> None:
        """Raise unless every rank holds the same integer `value`."""
        if self.group is None:
            return
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        vals = self.all_gather_rows(t, [1] * self.size).tolist()
        if len(set(vals)) != 1:
            raise RuntimeError(f"{name} differs across ranks: {vals}")


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, counts):
        ctx.rows = slice(sum(counts[:mesh.rank]),
                         sum(counts[:mesh.rank + 1]))
        return mesh.all_gather_rows(x, counts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None, None


def psum_replicated(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum of x over the ranks; its backward passes the (replicated)
    cotangent through unchanged, as JAX's psum transposes under
    shard_map."""
    if mesh.group is None:
        return x
    return _PsumReplicated.apply(x, mesh)


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh,
                    counts: Sequence[int]) -> torch.Tensor:
    """Every rank's rows concatenated (rank r holds counts[r] rows); the
    backward hands each rank its own rows of the cotangent."""
    if mesh.group is None:
        return x
    return _AllGatherRows.apply(x, mesh, list(counts))


def rank_device() -> torch.device:
    """This rank's card, cuda:(local rank % device count); raises on a host
    without one (the CPU is the caller's explicit choice: pass device)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build a mesh "
            "of CPU ranks")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def one_rank_mesh(device) -> DeviceMesh:
    """A mesh of this process alone (collectives are identities), whether
    or not a process group is up."""
    return DeviceMesh(None, 0, 1, torch.device(device))


def make_device_mesh(n_devices: Optional[int] = None,
                     device=None) -> DeviceMesh:
    """The world's mesh when a process group is up, else a one-rank mesh
    (collectives are identities).  n_devices, when given, must match.

    device: this rank's device (default: rank_device(), which needs a
        card)."""
    dev = torch.device(device) if device is not None else rank_device()
    if dist.is_initialized():
        size = dist.get_world_size()
        mesh = DeviceMesh(dist.group.WORLD, dist.get_rank(), size, dev)
    else:
        mesh = one_rank_mesh(dev)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"make_device_mesh({n_devices}): the world has "
                         f"{mesh.size} ranks")
    return mesh


def shard_along(mesh: DeviceMesh, t: torch.Tensor, axis: int = 0,
                unit: int = 1) -> torch.Tensor:
    """This rank's contiguous block of t along `axis`."""
    return t.narrow(axis, *_start_len(mesh.share(t.shape[axis], unit)))


def _start_len(s: slice):
    return s.start, s.stop - s.start


def replicated(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's t on every rank (in place)."""
    return mesh.broadcast_(t, 0)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def parallel_meshes_from_conf(conf, device=None):
    """The (spmd_mesh, atlas_mesh) pair a conf asks for, with the JAX
    package's rule read over ranks instead of local devices:

      train.atlas_tp  true with more than one rank → the atlas mesh (the
                      material atlases row-sharded, parallel.atlas_tp);
      train.spmd      true, or "auto" (the default) with more than one
                      rank → the spmd mesh (pixels / rays / points split
                      over the ranks, parameters replicated);
      otherwise       (None, None).
    """
    n = world_size()
    atlas_tp = conf.get("train.atlas_tp", False)
    spmd = conf.get("train.spmd", "auto")
    if atlas_tp and n > 1:
        return None, make_device_mesh(device=device)
    if spmd is True or (spmd == "auto" and n > 1):
        return make_device_mesh(device=device), None
    return None, None
