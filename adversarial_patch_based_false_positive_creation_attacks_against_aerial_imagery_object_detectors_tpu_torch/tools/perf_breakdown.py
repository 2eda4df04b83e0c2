"""Reproducible timing of the patch-optimization step on the current
devices (the repository's ``tools/perf_breakdown.py``): the default
training step (``make_train_step``, ``paper_obj`` shapes: 608^2 scenes,
patch 224, the full-width YOLOv3 with random weights in bfloat16; on a
card its stem runs K3a ``split_phases``, K1 ``save_acts`` and K3b
forward, the tiled K3a and K2 backward) at batch B on device-resident
batches (``step_profile.build_step``): 3 warm-up steps, then 30 timed.

The steps are timed by CUDA events around the timed series (the host's
clock on the CPU); the step compiles nothing but its kernels. One card,
or this rank's rows of the batch where the process was started under
``torch.distributed`` (``torchrun``). ``--device`` defaults to cuda and
raises where there is no card.

    python -m <package>.tools.perf_breakdown [B]
"""

from __future__ import annotations

import argparse

from ..models import last_routes
from ..utils.profiling import time_calls
from .step_profile import build_step

STEPS = 30


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    b, n = args.B, STEPS
    run, mesh = build_step(b, args.device)
    for _ in range(3):
        aux = run()
    float(aux["loss"])
    dt, loss = time_calls(lambda: run()["loss"], n, mesh.device, warmup=0)
    loss = float(loss)
    print(f"batch {b}: {dt * 1e3:.1f} ms/step  {b / dt:.1f} img/s  "
          f"{60 / dt:.0f} steps/min  devices={mesh.size}")
    return {"batch": b, "steps": n, "ms_per_step": dt * 1e3,
            "img_per_s": b / dt, "steps_per_min": 60 / dt,
            "devices": mesh.size, "loss": loss,
            "routes": dict(last_routes())}


if __name__ == "__main__":
    main()
