"""The readings a cell's limits are set from: the program's compared
numbers over many seeds (a short window each, then the check) and the
control's, the plain reference in the program's place in float8, on the
seeds given for it.

    python3 -m benchmark.calibrate --workload <cell> --seconds 3 \
        --seeds 1 2 3 ... --control-seeds 1 2 3

One JSON line a seed, then the largest program reading and the smallest
control reading of each number. ``--faults`` plants faults under the
timed path (``loops/patch_train.py``: ``state_unchanged``,
``half_batch``) to read what they give.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .core import ROOT, Bench, Env, log


def readings(root: str, workload: str, seed: int, seconds: float,
             lower=None, device="cuda", faults=()):
    """(numbers, numbers of the reference in the ``lower`` precision or
    None) of one seed, with ``faults`` planted under the timed path."""
    bench = Bench(root)
    cell = bench.cell(workload)
    env = Env(bench=bench, cell=cell, config=bench.config(cell["config"]),
              traffic=bench.traffic(cell["traffic"]), seed=seed,
              seconds=float(seconds), trace=False,
              device=torch.device(device), faults=tuple(faults))
    loop = bench.module("loops", env.traffic["loop"])
    state = loop.setup(env)
    loop.window(state, env, None)
    return loop.check(state, env, lower=lower)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--control-format", default="fp8",
                    choices=("fp8", "e5m2", "int8"),
                    help="the control's format: float8 e4m3 (fp8), e5m2, "
                         "or int8, each under a per-tensor scale")
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=(),
                    help="also read the reference in bfloat16, the "
                         "configuration's precision, on these seeds")
    ap.add_argument("--faults", nargs="*", default=(),
                    help="plant these faults (the readings that set a "
                         "training number's upper end)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("calibration needs a CUDA card")
        return 2
    lows, highs = {}, {}
    for seed in args.seeds:
        lower = (args.control_format if seed in args.control_seeds else
                 "bf16" if seed in args.witness_seeds else None)
        got, ctl = readings(ROOT, args.workload, seed, args.seconds, lower,
                            faults=args.faults)
        print(json.dumps({"seed": seed, "faults": args.faults,
                          "program": got, lower or "control": ctl}),
              flush=True)
        for k, v in got.items():
            lows[k] = max(lows.get(k, 0.0), v)
        for k, v in (ctl or {}).items() if lower != "bf16" else ():
            highs[k] = min(highs.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload,
                      "program_largest": lows,
                      "control_smallest": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
