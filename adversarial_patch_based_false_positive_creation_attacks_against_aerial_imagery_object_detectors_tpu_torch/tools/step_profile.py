"""Per-operation device-time attribution of the patch-optimization step
(the repository's ``tools/step_profile.py``).

Traces N default training steps at batch B (``build_step``: ``paper_obj``
shapes, 608^2, patch 224, bfloat16, the full-width YOLOv3 with random
weights) with ``utils.profiling.trace`` (``torch.profiler``) after three
warm-up steps, inside an ``apfp_steps`` annotation that ends with a
``torch.cuda.synchronize``. It then reads the Chrome trace: the card's
kernels, copies and sets inside that window (``device_intervals``),
each filed under the first category of ``CATEGORIES`` whose keys its
name contains (``categorize``), and prints the category table and the
25 operations with the most device time a step. The sums are over
operations, so overlapping ones count twice.

With ``STEP_PROFILE_TRACE`` set to a Chrome trace (``.json`` or
``.json.gz``) the tool parses that capture instead of running (N must
match the capture's step count for the per-step figures); its window
is the ``apfp_steps`` annotation where the trace has one, else the span
of its device operations. ``--device`` defaults to cuda and raises where
there is no card.

    python -m <package>.tools.step_profile [batch] [n_steps]
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import tempfile

import numpy as np
import torch

from .. import train as T
from ..attack.eot import draw_eot
from ..models import (Darknet, build_network, fold_bn, init_params,
                      yolov3_blocks)
from ..ops._cuda import resolve_device
from ..parallel.mesh import (batch_sharding, init_distributed, make_mesh,
                             replicated)
from ..utils import profiling

IMG, PATCH, MAX_LABELS = 608, 224, 252
WINDOW = "apfp_steps"

# (label, substrings of the kernel's name): the first match wins. The
# port's kernels by their symbols in ``csrc/*.cu``, then the libraries'
# GEMMs and convolutions (cuBLAS, cuDNN, CUTLASS), then PyTorch's own.
CATEGORIES = (
    ("stem-fwd", ("fused_stem_fwd", "fused_stem_remat")),
    ("stem-bwd", ("fused_stem_bwd",)),
    ("layout", ("to_planar", "from_planar")),
    ("planar-conv", ("planar_conv", "planar_convt2")),
    ("stage", ("res152_",)),
    ("median", ("median_",)),
    ("conv", ("gemm", "conv", "cudnn", "xmma", "cutlass", "sm90_", "wgrad",
              "dgrad", "implicit")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
    ("copy / set", ("Memcpy", "Memset", "copy", "Cat")),
)


def categorize(name: str) -> str:
    """The first category of ``CATEGORIES`` with a key in ``name``, else
    "other"."""
    return next((label for label, keys in CATEGORIES
                 if any(k in name for k in keys)), "other")


def device_intervals(events, window) -> tuple:
    """The device's kernels, copies and sets of a Chrome trace inside
    ``window`` (start, end in us): (merged busy intervals, [(start, end,
    name)])."""
    lo, hi = window
    ops = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi), e["name"])
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    merged = []
    for s, e, _ in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged, ops


def attribute(ops) -> tuple:
    """Device time (us) of ``device_intervals``' operations summed by
    name and by category: (by_op, by_category) ``Counter``s."""
    by_op = collections.Counter()
    for s, e, name in ops:
        by_op[name] += e - s
    by_cat = collections.Counter()
    for name, us in by_op.items():
        by_cat[categorize(name)] += us
    return by_op, by_cat


def steps_window(events) -> tuple:
    """(start, end) in us of the ``apfp_steps`` annotation, else of every
    device operation of the trace."""
    marks = [e for e in events if e.get("name") == WINDOW
             and e.get("ph") == "X"]
    if marks:
        return marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise ValueError("the trace holds no device operation")
    return (min(e["ts"] for e in dev),
            max(e["ts"] + e["dur"] for e in dev))


def read_trace(path: str) -> list:
    """The ``traceEvents`` of a Chrome trace, plain or gzipped."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def step_inputs(batch: int, label0=None) -> tuple:
    """The global batch of ``build_step`` as numpy arrays: ``batch``
    random scenes [B, IMG, IMG, 3] from ``default_rng(0)`` and labels
    [B, MAX_LABELS, 5] filled with 1e-6, whose first row is ``label0``
    in every scene where it is given (one real box)."""
    rng = np.random.default_rng(0)
    images = rng.random((batch, IMG, IMG, 3), np.float32)
    labels = np.full((batch, MAX_LABELS, 5), 1e-6, np.float32)
    if label0 is not None:
        labels[:, 0] = label0
    return images, labels


def build_step(batch: int, device="cuda", res152=None, label0=None,
               lr: float = 0.03):
    """The default training step at ``batch`` on device-resident inputs
    (``step_inputs``: random scenes from ``default_rng(0)``, labels filled
    with 1e-6, or with one real box ``label0`` first), a victim with
    random weights from seed 1 in bfloat16 and a patch from a generator
    seeded 0. One card, or this rank's rows of the batch where the process
    was started under ``torch.distributed`` (``torchrun``). ``res152`` is
    ``make_train_step``'s route of the 152^2 stage (None: the default
    route). Returns ``(run, mesh)``: ``run()`` takes one step (fresh EOT
    draws) at learning rate ``lr`` and returns its loss parts as device
    scalars."""
    dev = resolve_device(device)
    init_distributed(dev.type)
    mesh = make_mesh(dev)
    exp = T.ExperimentConfig(name="perf", img_size=IMG, patch_size=PATCH,
                             batch_size=batch, max_labels=MAX_LABELS,
                             compute_dtype="bfloat16")
    net = build_network(yolov3_blocks())
    model = Darknet(net, fold_bn(net, init_params(net, 1)), torch.bfloat16,
                    device=mesh.device).eval()
    step = T.make_train_step(model, exp, res152=res152, mesh=mesh)
    generator = torch.Generator(device=mesh.device)
    generator.manual_seed(0)
    patch = T.init_patch(exp, generator).requires_grad_(True)
    replicated(mesh, patch.data)
    optimizer = T.make_optimizer(patch, exp.learning_rate)
    cfg = T.eot_config(exp)
    rows = batch_sharding(mesh, batch)
    images, labels = (torch.from_numpy(a[rows]).to(mesh.device)
                      for a in step_inputs(batch, label0))

    def run():
        draws = draw_eot(generator, batch, PATCH, cfg)
        if mesh.distributed:
            draws = T.local_draws(draws, rows)
        return step(patch, optimizer, images, labels, lr, draws)

    return run, mesh


def capture(run, n: int, device: torch.device) -> str:
    """Trace ``n`` calls of ``run`` (warmed up by the caller) inside the
    ``apfp_steps`` annotation, which ends after a synchronize of
    ``device``; returns the Chrome trace's path (kept, in a new temporary
    directory)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tmp = tempfile.mkdtemp(prefix="stepprof_")
    with profiling.trace(tmp):
        with profiling.annotate(WINDOW):
            for _ in range(n):
                run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    traces = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
    if not traces:
        raise RuntimeError(f"no trace written under {tmp}")
    return traces[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("n_steps", nargs="?", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    b, n = args.batch, args.n_steps
    path = os.environ.get("STEP_PROFILE_TRACE")
    if not path:
        run, mesh = build_step(b, args.device)
        for _ in range(3):
            run()
        path = capture(run, n, mesh.device)
    events = read_trace(path)
    window = steps_window(events)
    merged, ops = device_intervals(events, window)
    by_op, by_cat = attribute(ops)
    total = sum(by_op.values())
    if not total:
        raise ValueError(f"{path}: no device time inside the steps' window")

    per_step = total / n / 1e3
    print(f"\nbatch {b}, {n} steps; device op time "
          f"{per_step:.2f} ms/step (sum over ops)\n")
    print(f"{'category':<20}{'ms/step':>9}  {'%':>5}")
    for cat, us in by_cat.most_common():
        print(f"{cat:<20}{us / n / 1e3:>9.3f}  {us / total * 100:>5.1f}")
    print("\ntop 25 ops (ms/step):")
    for name, us in by_op.most_common(25):
        print(f"  {us / n / 1e3:>8.3f}  {name[:100]}")
    # keep the raw trace for manual inspection
    print(f"\ntrace: {path}")
    busy = sum(e - s for s, e in merged)
    return {"batch": b, "steps": n, "trace": path,
            "window_ms": (window[1] - window[0]) / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_ms_per_step": per_step,
            "ms_per_step_by_category": {c: us / n / 1e3
                                        for c, us in by_cat.most_common()},
            "top_ops_ms_per_step": [(name, us / n / 1e3)
                                    for name, us in by_op.most_common(25)]}


if __name__ == "__main__":
    main()
