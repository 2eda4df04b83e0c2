"""Benchmark: patch-optimization steps/min on the flagship pipeline (the
repository's ``bench.py`` on the port).

Measures the default training step (EOT transform + composite + the
full-width YOLOv3 forward and input backward + creation losses + amsgrad
update: ``step_profile.build_step``, its stem on K3a ``split_phases``, K1
``save_acts`` and K3b forward, the tiled K3a and K2 backward) at a global
batch of 8, 608x608, the detector in bfloat16, on every card present: one
process a card (ranks of one NCCL group, the batch split over them; with
one card a single process and no group). 3 warm-up steps, then 30 timed
by the host's clock between two ``torch.cuda.synchronize`` calls.

The last line is ONE JSON record: {"metric", "value", "unit",
"vs_baseline", "ms_per_step"}, and "mfu" where the card has a known bf16
peak (``models/flops.py``). ``vs_baseline`` is the image-throughput ratio
vs. the reference's logged V100S run (~0.8 steps/s at batch 24 => 19.2
img/s; BASELINE.md). The lines before it start with "#": the cards' names
and power limits, the same 30 steps by CUDA events beside the host's time
to issue them (where the two agree, the host sets the pace, not the
card), the routes the victim took, and rank 0's kernel launch counts.

The process handling is ``bench.py``'s: a device probe
(``torch.cuda.device_count()``) in a time-bounded subprocess, then the
measurement in time-bounded children, with bounded retries
(``parallel/mesh.py: count_cards``, ``run_ranks``: a child outlives
neither its timeout nor a SIGTERM to this process). If no attempt
succeeds, the record is still printed, with an "error" field and value
0.0, and the process exits 0.

One deliberate deviation: ``bench.py`` falls back to the XLA stem when
its kernels fail, and tags the record. Here there is no fallback: a
kernel that fails to build or launch ends the child, and the record is
the "error" one.

    python -m <package>.tools.bench
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time

import torch

from ..ops import kernel_launches
from ..parallel.mesh import child_env, count_cards, run_ranks

BATCH = 8
IMG = 608
REFERENCE_IMG_PER_S = 19.2  # V100S, batch 24, ~0.8 steps/s (BASELINE.md)
METRIC = f"patch_train_steps_per_min_b{BATCH}"
# bench.py's step: one real box first in every scene, lr 0.03, then 3
# warm-up steps and 30 timed
LABEL0 = (0.0, 0.5, 0.5, 0.1, 0.15)
LR = 0.03
WARMUP, STEPS = 3, 30

_CHILD_SENTINEL = "_ADV_BENCH_CHILD"
_ATTEMPTS = 3
_BACKOFF_S = 45.0
_PROBE_TIMEOUT_S = 60.0
# bench.py's bounds: the first attempt also builds the kernels and warms
# the step; a retry after a timeout deals with a hang and gets less
_CHILD_TIMEOUT_S = 1200.0
_CHILD_RETRY_TIMEOUT_S = 480.0
# what a child runs after ``python``
_CHILD_ARGS = ("-m", f"{__package__}.bench")


def bench_record(seconds: float, n_steps: int, n_dev: int,
                 mfu=None) -> dict:
    """``bench.py``'s record of ``n_steps`` steps of the global batch in
    ``seconds`` on ``n_dev`` cards."""
    record = {
        "metric": f"{METRIC}_{n_dev}dev",
        "value": round(n_steps / seconds * 60.0, 2),
        "unit": "steps/min",
        "vs_baseline": round(n_steps * BATCH / seconds
                             / REFERENCE_IMG_PER_S, 3),
        "ms_per_step": round(seconds / n_steps * 1e3, 2),
    }
    if mfu is not None:
        record["mfu"] = round(mfu, 4)
    return record


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (subprocess.TimeoutExpired, OSError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(out.stdout.strip().splitlines()) or "nvidia-smi: none"


def _run_bench() -> dict:
    """The measurement (a child, one a card). Rank 0 prints the "#"
    lines and the JSON record."""
    import torch.distributed as dist

    from ..models import build_network, flops, last_routes, yolov3_blocks
    from .step_profile import build_step

    run, mesh = build_step(BATCH, "cuda", label0=LABEL0, lr=LR)
    kernel_launches(reset=True)
    for _ in range(WARMUP):
        run()
    torch.cuda.synchronize(mesh.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS):
        aux = run()
    issued = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize(mesh.device)
    dt = time.perf_counter() - t0
    loss = float(aux["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"the bench step's loss is {loss}")
    launches = kernel_launches()
    net = build_network(yolov3_blocks())
    mfu = flops.mfu(dt / STEPS, BATCH, net,
                    torch.cuda.get_device_name(mesh.device),
                    n_devices=mesh.size)
    record = bench_record(dt, STEPS, mesh.size, mfu)
    if mesh.rank == 0:
        ms = 1e3 / STEPS
        print(f"# card: {_card_line()}")
        print(f"# device: {STEPS} steps, CUDA events "
              f"{start.elapsed_time(end) / STEPS:.2f} ms a step, host "
              f"issue {issued * ms:.2f} ms a step, host clock "
              f"{dt * ms:.2f} ms a step, loss {loss:.4f}, rank 0 of "
              f"{mesh.size}")
        print(f"# routes: {json.dumps(last_routes())}")
        print(f"# launches: {json.dumps(launches)}")
        print(json.dumps(record), flush=True)
    if mesh.distributed:
        dist.destroy_process_group()
    return record


def _probe_device_count() -> int:
    """Count the cards in a time-bounded subprocess; 0 on a timeout or a
    crash. Out of process because a backend's initialization can hang
    rather than raise."""
    return count_cards(_PROBE_TIMEOUT_S)


def _extract_json_line(text: str) -> str:
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "metric" in rec and "value" in rec:
                return line
    return ""


def _ranks(cards: int) -> int:
    """The most cards, up to ``cards``, that split the batch evenly."""
    return max(r for r in range(1, min(cards, BATCH) + 1) if BATCH % r == 0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if os.environ.get(_CHILD_SENTINEL) == "1":
        return _run_bench()

    last_err = "no attempt ran"
    for attempt in range(_ATTEMPTS):
        if attempt:
            print(f"# backend unavailable ({last_err}); retrying in "
                  f"{_BACKOFF_S:.0f}s ({attempt + 1}/{_ATTEMPTS})",
                  flush=True)
            time.sleep(_BACKOFF_S)
        cards = _probe_device_count()
        if cards < 1:
            last_err = "device probe failed/timed out"
            continue
        child_timeout = (_CHILD_TIMEOUT_S if attempt == 0
                         else _CHILD_RETRY_TIMEOUT_S)
        try:
            outs = run_ranks(_CHILD_ARGS, _ranks(cards),
                             child_env(**{_CHILD_SENTINEL: "1"}),
                             child_timeout)
        except subprocess.TimeoutExpired:
            last_err = f"bench child timed out after {child_timeout:.0f}s"
            continue
        line = _extract_json_line(outs[0][1])
        failed = [(r, rc, err) for r, (rc, _, err) in enumerate(outs) if rc]
        if not failed and line:
            for extra in outs[0][1].strip().splitlines():
                if extra.strip().startswith("#"):
                    print(extra, flush=True)
            print(line, flush=True)
            return json.loads(line)
        r, rc, err = failed[0] if failed else (0, 0, outs[0][2])
        who = f"bench child rc={rc}" + (f" (rank {r})" if len(outs) > 1
                                         else "")
        last_err = (f"{who}: " + err.strip().splitlines()[-1][-300:]
                    if err.strip() else who)
    record = {
        "metric": f"{METRIC}_0dev",
        "value": 0.0,
        "unit": "steps/min",
        "vs_baseline": 0.0,
        "error": last_err,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
