"""The repository's root entry points (its ``__graft_entry__.py``) on the
port.

- ``entry()``: the flagship detector's forward (the full-width
  YOLOv3-DOTA victim, 608x608, NHWC, BN-folded random weights from seed
  0, bfloat16; three raw heads out) and its example arguments.
- ``dryrun_multichip(n)``: ONE full patch-optimization training step (EOT
  + detector fwd/bwd + creation losses + amsgrad update) on n ranks, one
  process each, with the real data-parallel layout
  (``make_train_step(mesh=)``: the batch split over the ranks, the patch
  and the optimizer state replicated) on tiny shapes, then a hard check
  that the ranks carry that layout (``_assert_layouts``).

Where the dryrun's processes run: ``device="cuda"``, the default, starts
n NCCL processes, one card each, and raises where there is no card or a
time-bounded out-of-process probe (``_probe_device_count``) finds fewer
than n; it never moves to the CPU. ``device="cpu"`` starts n gloo
processes that see no card. One deliberate deviation:
``__graft_entry__.py`` picks the platform itself (the cards where its
probe finds n, else the CPU); here the caller picks it, as every entry
point of the port. The platform is named in the printed line and in the
returned record.

    python -m <package>.tools.entry [n] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import tempfile

import numpy as np
import torch

from .. import train as T
from ..attack.eot import EOTDraws, draw_eot
from ..models import (Darknet, build_network, fold_bn, init_params,
                      tiny_test_blocks, yolov3_blocks)
from ..ops._cuda import no_tf32, resolve_device
from ..parallel.mesh import (batch_sharding, child_env, count_cards,
                             init_distributed, make_mesh, replicated,
                             run_ranks)

_CHILD_SENTINEL = "_GRAFT_DRYRUN_CHILD"
_PROBE_TIMEOUT_S = 60.0
_DRYRUN_TIMEOUT_S = 600.0

FULL_IMG = 608
# the dryrun's recipe (``__graft_entry__.py``): the miniature 3-scale
# darknet at 64^2 in float32, a 16^2 patch, 2 scenes a rank, 8 label rows
# (one real box first), lr 0.03
IMG, PATCH, MAX_LABELS, LR = 64, 16, 8, 0.03
LABEL0 = (0.0, 0.5, 0.5, 0.2, 0.3)


def entry(device="cuda"):
    """``(fn, example_args)`` for a one-card check of the flagship
    detector's forward: ``fn(*example_args)`` (a zero [1, 608, 608, 3]
    float32 image) gives the three raw heads [1, 19, 19, 60], [1, 38, 38,
    60] and [1, 76, 76, 60] in float32, without autograd. ``fn`` asks for
    the stem kernels where ``Detector`` does (on a card: the fused stem,
    else the planar one). The JAX package's ``apply`` skips its fused stem
    at a local batch of 1, a crossover measured on a TPU v5e, not on
    this card. ``fn.model`` is the ``Darknet``."""
    dev = resolve_device(device)
    net = build_network(yolov3_blocks())
    model = Darknet(net, fold_bn(net, init_params(net, 0)), torch.bfloat16,
                    device=dev).eval()
    kernels = dev.type == "cuda"

    def forward(images):
        with torch.inference_mode():
            return model(images, fused_stem=kernels, planar_stem=kernels)

    forward.model = model
    images = torch.zeros((1, FULL_IMG, FULL_IMG, 3), dtype=torch.float32,
                         device=dev)
    return forward, (images,)


def _probe_device_count() -> int:
    """Count the visible cards in a time-bounded subprocess; 0 on a
    timeout, a crash or unparseable output."""
    return count_cards(_PROBE_TIMEOUT_S)


def dryrun_multichip(n_devices: int = 8, device="cuda",
                     workdir=None) -> dict:
    """Run the full training step on a genuine ``n_devices``-rank group
    (see the module's docstring for where) and check its layout. Prints
    rank 0's line ``dryrun_multichip(n): ok, n-way <platform> mesh, <k>-img
    shards, loss=<x>`` and returns its record (``n``, ``platform``,
    ``shard_rows``, ``loss``, ``line``). ``workdir`` keeps each rank's
    results there (``rank<r>.pt``); an ``inputs.pt`` there (any of
    ``params``, ``patch``, ``draws``) replaces the step's own inputs."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = _probe_device_count()
        if cards < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) on cuda needs {n_devices} "
                f"cards, the probe found {cards}; pass device='cpu' for "
                f"gloo ranks")
    return _launch(n_devices, dev.type, workdir)


def _launch(n_devices: int, device: str, workdir=None) -> dict:
    """``__graft_entry__.py``'s CPU re-exec, for either platform: the
    dryrun as ``n_devices`` fresh processes of this module (ranks of one
    group: gloo where no card is visible, NCCL on cards 0..n-1), which
    inherit none of the JAX package's platform switches. Raises where a
    rank fails or the ranks outlast ``_DRYRUN_TIMEOUT_S``."""
    wd = workdir or tempfile.mkdtemp(prefix="dryrun_")
    env = child_env(**{_CHILD_SENTINEL: "1"})
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // n_devices)))
    try:
        outs = run_ranks(("-m", f"{__package__}.entry", str(n_devices),
                          "--device", device, "--workdir", wd), n_devices,
                         env, _DRYRUN_TIMEOUT_S, group=True)
        for r, (rc, out, err) in enumerate(outs):
            if rc:
                raise RuntimeError(f"dryrun rank {r} exited {rc}:\n"
                                   f"{(out + err)[-3000:]}")
        res = torch.load(os.path.join(wd, "rank0.pt"), weights_only=True)
    finally:
        if workdir is None:
            shutil.rmtree(wd, ignore_errors=True)
    record = {"n": n_devices, "platform": res["platform"],
              "shard_rows": res["shard_rows"], "loss": res["loss"],
              "line": _line(n_devices, res)}
    print(record["line"], flush=True)
    return record


def _line(n_devices: int, res: dict) -> str:
    return (f"dryrun_multichip({n_devices}): ok, {res['mesh_size']}-way "
            f"{res['platform']} mesh, {res['shard_rows']}-img shards, "
            f"loss={res['loss']:.4f}")


def _rank_views(mesh, rows: slice, images: torch.Tensor, state) -> list:
    """Every rank's view of the layout, in rank order (one
    ``all_gather_object``): its rows of the batch, the scenes it holds and
    its replicated tensors, on the host."""
    import torch.distributed as dist
    view = {"rows": (rows.start, rows.stop), "images": images.cpu(),
            "state": [t.detach().cpu() for t in state]}
    views = [None] * mesh.size
    dist.all_gather_object(views, view, group=mesh.group)
    return views


def _assert_layouts(views, n_devices: int, batch: int, images) -> None:
    """The dryrun proves the layout, not just that a step ran: ``views``
    (``_rank_views``) come from ``n_devices`` ranks, each holding
    ``batch // n_devices`` rows of the batch, disjoint, in rank order and
    together the global ``images``; the patch and every optimizer-state
    tensor are equal bit for bit on every rank."""
    assert len(views) == n_devices, f"{len(views)} ranks"
    k = batch // n_devices
    for r, v in enumerate(views):
        assert v["rows"] == (r * k, (r + 1) * k), (r, v["rows"])
        assert v["images"].shape[0] == k, (r, tuple(v["images"].shape))
    assert torch.equal(torch.cat([v["images"] for v in views]),
                       torch.as_tensor(images)), \
        "the ranks' rows in order are not the batch"
    ref = views[0]["state"]
    for r, v in enumerate(views[1:], 1):
        assert len(v["state"]) == len(ref), (r, len(v["state"]))
        for i, (a, b) in enumerate(zip(v["state"], ref)):
            assert torch.equal(a, b), \
                f"rank {r}: replicated tensor {i} differs from rank 0's"


def _dryrun_impl(n_devices: int, device: str, params=None, patch=None,
                 draws=None) -> dict:
    """One rank of the dryrun (the launcher's variables name the group):
    the step on this rank's rows, then the checks. ``params`` (folded),
    ``patch`` [16, 16, 3] and ``draws`` (the global batch's ``EOTDraws``)
    replace the step's own inputs where given. Returns this rank's
    result: loss, patch, optimizer state, platform and mesh."""
    dev = resolve_device(device)
    if not init_distributed(dev.type):
        raise RuntimeError("the dryrun's ranks need the launcher's "
                           "variables (RANK, WORLD_SIZE, ...)")
    mesh = make_mesh(dev.type)
    assert mesh.size == n_devices, (mesh.size, n_devices)

    # The victim is the miniature 3-scale darknet (every block type, all
    # three heads) rather than the full 75-conv graph: the layout is the
    # same either way, and the dryrun stays seconds long on a CPU host.
    batch = 2 * n_devices
    exp = T.ExperimentConfig(
        name="dryrun", img_size=IMG, patch_size=PATCH, batch_size=batch,
        max_labels=MAX_LABELS, compute_dtype="float32")
    net = build_network(tiny_test_blocks(width=IMG, height=IMG))
    if params is None:
        params = fold_bn(net, init_params(net, 1))
    model = Darknet(net, params, torch.float32, device=mesh.device).eval()
    generator = torch.Generator(device=mesh.device)
    generator.manual_seed(0)
    p = (T.init_patch(exp, generator) if patch is None
         else torch.as_tensor(patch, dtype=torch.float32).to(mesh.device))
    p = p.clone().requires_grad_(True)
    replicated(mesh, p.data)
    optimizer = T.make_optimizer(p, LR)
    step = T.make_train_step(model, exp, mesh=mesh)

    rng = np.random.default_rng(0)
    images = rng.random((batch, IMG, IMG, 3), np.float32)
    labels = np.full((batch, MAX_LABELS, 5), 1e-6, np.float32)
    labels[:, 0] = LABEL0
    rows = batch_sharding(mesh, batch)
    x, y = (torch.from_numpy(a[rows]).to(mesh.device)
            for a in (images, labels))
    if draws is None:
        draws = draw_eot(generator, batch, PATCH, T.eot_config(exp))
    draws = EOTDraws(**{k: v.to(mesh.device) for k, v in
                        vars(T.local_draws(draws, rows)).items()})
    with no_tf32():
        aux = step(p, optimizer, x, y, LR, draws)
    loss = float(aux["loss"])
    assert math.isfinite(loss), f"non-finite loss {loss}"
    opt = optimizer.state[p]
    state = [p] + [opt[k] for k in sorted(opt)]
    _assert_layouts(_rank_views(mesh, rows, x, state), n_devices, batch,
                    images)
    return {"loss": loss, "patch": p.detach().cpu(),
            "opt": {k: v.cpu() for k, v in opt.items()},
            "platform": dev.type, "mesh_size": mesh.size,
            "shard_rows": batch // n_devices}


def _rank_main(n_devices: int, device: str, workdir: str) -> dict:
    """A rank's process: the step's inputs from ``workdir/inputs.pt``
    where present, its result to ``workdir/rank<r>.pt``; rank 0 prints
    the dryrun's line."""
    import torch.distributed as dist
    kw = {}
    path = os.path.join(workdir, "inputs.pt")
    if os.path.exists(path):
        kw = torch.load(path, weights_only=True)
        if "draws" in kw:
            kw["draws"] = EOTDraws(**kw["draws"])
    try:
        res = _dryrun_impl(n_devices, device, **kw)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rank = int(os.environ["RANK"])
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    if rank == 0:
        print(_line(n_devices, res), flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="ranks of the dryrun (default 8)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): n NCCL processes, one card each "
                         "(raises with fewer cards); cpu: n gloo "
                         "processes")
    ap.add_argument("--workdir", default=None,
                    help="keep each rank's results (rank<r>.pt) here; an "
                         "inputs.pt here (params, patch, draws) replaces "
                         "the step's own inputs")
    args = ap.parse_args(argv)
    if os.environ.get(_CHILD_SENTINEL) == "1":
        return _rank_main(args.n, args.device, args.workdir)
    return dryrun_multichip(args.n, args.device, args.workdir)


if __name__ == "__main__":
    main()
