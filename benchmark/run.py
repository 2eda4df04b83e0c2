"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic names a loop (``benchmark/loops/<loop>.py``)
with ``setup(env)``, ``window(state, env, tracer)`` and
``check(state, env)``. A run: the card check; set-up (inputs and weights
from the seed, the warm-up), timed as ``setup_s`` from process start;
the measured window of ``--seconds`` (with ``--trace 1``, its last
``trace_seconds`` under ``torch.profiler``); the peak memory; the check
against the plain reference; the per-layer readers
(``benchmark/metrics/<metric>.py``, with ``--trace 1``); the numbers
compared, each beside its limit, as the last lines on standard error;
the result as one JSON line, last on standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from .core import (ROOT, Bench, Env, Reading, forbidden_modules,  # noqa: E402
                   log)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def finite(v: float) -> float:
    """``v``, with an infinite reading written as the largest float (the
    result line is strict JSON)."""
    return v if math.isfinite(v) else 1.7976931348623157e308


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", faults=(), out=sys.stdout) -> dict:
    """One run of ``workload`` on ``device``; prints and returns the
    result. ``faults`` plants a fault under the timed path (tests)."""
    import torch
    from . import port
    from .trace import Tracer

    bench = Bench(root)
    cell = bench.cell(workload)
    env = Env(bench=bench, cell=cell, config=bench.config(cell["config"]),
              traffic=bench.traffic(cell["traffic"]), seed=seed,
              seconds=float(seconds), trace=bool(trace),
              device=torch.device(device), faults=tuple(faults))
    loop = bench.module("loops", env.traffic["loop"])
    limits = env.config["limits"][env.traffic["loop"]]
    cuda = env.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(env.device)
    port.kernel_launches(reset=True)
    state = loop.setup(env)
    tracer = Tracer(env.device) if trace else None
    if tracer is not None:
        tracer.warm()
    setup_s = time.perf_counter() - T_START
    res = loop.window(state, env, tracer)
    peak = torch.cuda.max_memory_allocated(env.device) if cuda else 0
    launches = port.kernel_launches()
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package was loaded: {found}")
        raise SystemExit(3)
    tr = tracer.read() if tracer is not None else None
    got, _ = loop.check(state, env)
    name = torch.cuda.get_device_name(env.device) if cuda else "cpu"
    print(f"# card: {card_line() if cuda else 'cpu'}", file=out)
    print(f"# kernel launches since set-up began: {json.dumps(launches)}",
          file=out)
    metrics = {}
    if trace:
        reading = Reading(env=env, window=res, trace=tr, device_name=name)
        for m in bench.per_layer(workload):
            value = bench.module("metrics", m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": finite(value),
                                      "unit": m["unit"]}
    else:
        values = dict(res.e2e, setup_s=setup_s)
        for m in bench.end_to_end(workload):
            # "<quantity>.<cells>" is the loop's <quantity> under a bound
            # of its own for those cells
            value = values.get(m["name"], values.get(m["name"].split(".")[0]))
            metrics[m["name"]] = {"value": finite(value), "unit": m["unit"]}
    compared = {k: {"value": finite(got[k]), "limit": v}
                for k, v in limits.items()}
    correct = all(got[k] <= v for k, v in limits.items())
    device = {"platform": "gpu" if cuda else "cpu", "kind": name,
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": res.attempted,
              "failed": res.failed, "metrics": metrics, "device": device}
    if tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["compared"] = compared
    for k in sorted(set(got) - set(limits)):
        log(f"read, not compared: {k} {got[k]!r}")
    for k, v in compared.items():
        log(f"compared {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    bench = Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    run_cell(ROOT, args.workload, args.seed, args.seconds,
             bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
