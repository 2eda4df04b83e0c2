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

The entry points that start their own ranks or children do so with
``run_ranks`` (the launcher's variables, a free local port), and count
the cards out of process with ``count_cards``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..ops._cuda import resolve_device

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# the card count, printed by a process of its own (a backend's
# initialization can hang rather than raise)
PROBE_CODE = "import torch; print(torch.cuda.device_count())"
# the processes ``run_ranks`` starts run from the directory that holds
# the package
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# seconds between SIGTERM and SIGKILL when ``run_ranks`` stops its
# processes
_STOP_GRACE_S = 10.0


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


def free_port() -> int:
    """A free TCP port on the local host, for one process group's
    ``MASTER_PORT``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(**extra) -> dict:
    """This process's environment for a child, less the launcher's
    variables (``run_ranks`` sets its own) and the JAX package's platform
    switches, plus ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ENV + ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(extra)
    return env


def count_cards(timeout: float) -> int:
    """Run ``PROBE_CODE`` in a process of its own and read the last
    integer it prints: 0 on a timeout, a crash or output without one (all
    three mean the backend cannot be trusted to supply cards now)."""
    try:
        out = subprocess.run([sys.executable, "-c", PROBE_CODE],
                             capture_output=True, text=True,
                             timeout=timeout, env=child_env())
    except (subprocess.TimeoutExpired, OSError):
        return 0
    if out.returncode != 0:
        return 0
    for line in reversed(out.stdout.strip().splitlines()):
        try:
            return int(line.strip())
        except ValueError:
            continue
    return 0


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def _stop(procs) -> None:
    """End each live process and what it started (its session): SIGTERM,
    then SIGKILL after ``_STOP_GRACE_S``."""
    live = [p for p in procs if p.poll() is None]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for p in live:
            try:
                os.killpg(p.pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + _STOP_GRACE_S
        for p in live:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        live = [p for p in live if p.poll() is None]
        if not live:
            return


def run_ranks(args, n: int, env: dict, timeout: float,
              group: bool = False) -> list:
    """Run ``python *args`` as ``n`` processes from the package's parent
    directory, each in a session of its own: ranks 0..n-1 of one group
    (the launcher's variables, a free local port; card r for rank r) where
    ``n > 1`` or ``group``, else one process without them. Returns
    ``[(returncode, stdout, stderr)]`` in rank order. When ``timeout``
    seconds pass first, stops every process (and what it started) and
    raises ``subprocess.TimeoutExpired``. A SIGTERM to this process
    meanwhile (on the main thread) raises ``SystemExit`` here, so the
    processes are stopped all the same."""
    base = dict(env)
    if n > 1 or group:
        base.update(WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(free_port()))
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        saved = signal.signal(signal.SIGTERM, _terminated)
    procs, files = [], []
    try:
        for r in range(n):
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files += [out, err]
            rank_env = (dict(base, RANK=str(r), LOCAL_RANK=str(r))
                        if "WORLD_SIZE" in base else base)
            procs.append(subprocess.Popen(
                [sys.executable, *args], cwd=_ROOT, env=rank_env,
                stdout=out, stderr=err, start_new_session=True))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        results = []
        for p, out, err in zip(procs, files[::2], files[1::2]):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode,
                            out.read().decode(errors="replace"),
                            err.read().decode(errors="replace")))
        return results
    finally:
        _stop(procs)
        for f in files:
            f.close()
        if on_main:
            # None: a handler that was not set from Python
            signal.signal(signal.SIGTERM,
                          signal.SIG_DFL if saved is None else saved)
