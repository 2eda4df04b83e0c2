"""Data parallelism on ``torch.distributed`` (the JAX package's
``parallel/mesh.py``).

The JAX package shards the batch over a 1-D "data" mesh and lets XLA
insert the gradient ``psum``. Here one process drives one card (the
``torchrun`` idiom): a ``Mesh`` names the process group, its size, this
process's rank and card. Each rank takes its contiguous rows of the
global batch (``batch_sharding``, ``shard_batch``); the patch and the
optimizer state are replicated (``replicated`` broadcasts from rank 0);
the trainer gathers the per-sample loss inputs (``gather_rows``) so that
every batch mean runs over the global batch, and sums the patch gradient
over the ranks (``all_reduce_sum``) before the update.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..ops._cuda import resolve_device

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One process per card. ``group`` is the process group (None for a
    one-process mesh), ``size`` its rank count, ``rank`` this process's
    rank in it (None for a process that the mesh leaves out) and
    ``device`` this process's device."""
    group: Optional[dist.ProcessGroup]
    size: int
    rank: Optional[int]
    device: torch.device

    @classmethod
    def single(cls, device) -> "Mesh":
        """One process on ``device``: nothing to gather or reduce."""
        return cls(None, 1, 0, torch.device(device))

    @property
    def member(self) -> bool:
        return self.rank is not None

    @property
    def distributed(self) -> bool:
        """True where the step must gather and reduce across ranks."""
        return self.size > 1


def init_distributed(device="cuda") -> bool:
    """Join the process group that ``torchrun`` (or any launcher setting
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``) describes: ``nccl`` with this process on card
    ``LOCAL_RANK`` for ``device="cuda"`` (raises where there is no card),
    ``gloo`` for ``device="cpu"``. Returns False, and does nothing, when
    those variables are absent; True once the group is up (also when it
    already was)."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ENV):
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return True


def _device() -> torch.device:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(device="cuda") -> Mesh:
    """The mesh over every rank of the default process group; without
    one, a one-process mesh on ``device``."""
    if not dist.is_initialized():
        return Mesh.single(resolve_device(device))
    return Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(),
                _device())


def make_mesh_for_batch(batch_size: int, device="cuda") -> Mesh:
    """The mesh over the largest rank count that divides the batch (a
    4-image batch with 8 ranks uses ranks 0-3), so every rank takes the
    same number of rows. Every rank must call it (it creates the
    subgroup). The ranks left out get a mesh with ``rank=None``
    (``member`` False): they take no part in training, and the training
    CLI returns on them at once."""
    mesh = make_mesh(device)
    n = mesh.size
    while n > 1 and batch_size % n != 0:
        n -= 1
    if n == mesh.size:
        return mesh
    group = dist.new_group(list(range(n)))
    rank = mesh.rank if mesh.rank < n else None
    return Mesh(group if rank is not None else None, n, rank, mesh.device)


def batch_sharding(mesh: Mesh, batch_size: int) -> slice:
    """This rank's contiguous rows of a global batch of ``batch_size``."""
    if batch_size % mesh.size:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{mesh.size} ranks")
    b = batch_size // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each array (numpy or tensor, batch axis first)
    as tensors on the mesh's device."""
    out = tuple(torch.as_tensor(a[batch_sharding(mesh, len(a))]).to(
        mesh.device) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicated(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` made equal on every rank: broadcast in place from rank
    0 (a no-op on a one-process mesh). Returns it."""
    if mesh.distributed:
        dist.broadcast(tensor, src=dist.get_global_rank(mesh.group, 0),
                       group=mesh.group)
    return tensor


def all_reduce_sum(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place. Returns it."""
    if mesh.distributed:
        dist.all_reduce(tensor, group=mesh.group)
    return tensor


def gather_rows(mesh: Mesh, *parts: torch.Tensor):
    """The global batch of each per-sample tensor ``[b, ...]`` (ranks in
    order, one collective for all of them). This rank's rows keep their
    autograd graph; the other ranks' are constants, so a loss over the
    global batch differentiates through the local samples alone and the
    ranks' gradients sum to the global one."""
    b = parts[0].shape[0]
    flat = [p.reshape(b, -1) for p in parts]
    local = torch.cat(flat, dim=1)
    bufs = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(bufs, local.detach().contiguous(), group=mesh.group)
    bufs[mesh.rank] = local
    full = torch.cat(bufs)
    out, col = [], 0
    for p, f in zip(parts, flat):
        out.append(full[:, col:col + f.shape[1]].reshape(
            (full.shape[0],) + tuple(p.shape[1:])))
        col += f.shape[1]
    return out
