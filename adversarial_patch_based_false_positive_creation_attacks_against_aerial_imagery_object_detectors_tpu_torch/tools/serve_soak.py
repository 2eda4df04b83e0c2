"""Serving-path soak (the repository's ``tools/serve_soak.py``): a
sustained mixed-load run of the micro-batching ``DetectionService``
(``evals/serving.py``) with latency percentiles and host-memory
stability tracking.

Where ``serving_throughput`` measures a short burst's peak rate, this
runs for ``--duration`` seconds of continuous concurrent request
pressure (uint8 wire by default, the production serving configuration of
``cli.serve``) and reports what a deployment cares about: sustained
req/s, p50 / p95 / p99 request latency, device-batch fill, and RSS drift
(a leak in the batcher or result-fetch path shows as monotone RSS growth
over a 30-minute soak). The client count ramps in thirds (full -> half
-> full, ``clients_at``) so the batcher sees both saturated and
partially filled windows.

The detector is the full-width YOLOv3 (random weights from seed 0,
bfloat16). Latencies are the host's clock around each ``submit``, whose
result has come back to the host; the detector compiles nothing but its
kernels, and one warm request runs before the clock starts.
``--device`` defaults to cuda and raises where there is no card.

    python -m <package>.tools.serve_soak [--duration 1800] [--max-batch 8]
        [--clients 16] [--wire uint8] [--out soak.json]
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from ..evals.serving import DetectionService
from .serving_throughput import build_detector, device_count


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def clients_at(elapsed: float, duration: float, clients: int) -> int:
    """The live client target ``elapsed`` seconds in: the middle third of
    the run at half the clients (partial batches), else all of them."""
    third = duration / 3.0
    return (max(1, clients // 2) if third < elapsed < 2 * third
            else clients)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=1800.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--wire", default="uint8",
                    choices=["uint8", "float32"])
    ap.add_argument("--img-size", type=int, default=608)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    wire = np.dtype(args.wire)

    det = build_detector(args.device)
    svc = DetectionService(det, max_batch=args.max_batch, window_ms=10.0,
                           conf_thresh=0.4, nms_thresh=0.4,
                           wire_dtype=wire)
    rng = np.random.default_rng(0)
    S = args.img_size
    if wire == np.uint8:
        pool_imgs = [rng.integers(0, 256, (S, S, 3), dtype=np.uint8)
                     for _ in range(8)]
    else:
        pool_imgs = [rng.random((S, S, 3)).astype(np.float32)
                     for _ in range(8)]

    latencies = []        # seconds, appended under lock
    lat_lock = threading.Lock()
    stop = threading.Event()
    t_end = [0.0]
    phase = [args.clients]  # live client target for the ramp

    def client(idx):
        i = idx
        while not stop.is_set() and time.perf_counter() < t_end[0]:
            if idx >= phase[0]:     # ramped-down client idles
                time.sleep(0.05)
                continue
            t0 = time.perf_counter()
            svc.submit(pool_imgs[i % len(pool_imgs)])
            dt = time.perf_counter() - t0
            with lat_lock:
                latencies.append(dt)
            i += 1

    rss_samples = []
    with svc:
        svc.submit(pool_imgs[0])            # warm-up outside timing
        rss_samples.append((0.0, rss_mb()))
        t0 = time.perf_counter()
        t_end[0] = t0 + args.duration
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(args.clients)]
        for t in threads:
            t.start()
        next_report = t0 + 30.0
        while time.perf_counter() < t_end[0]:
            time.sleep(min(10.0, max(0.1, t_end[0] - time.perf_counter())))
            el = time.perf_counter() - t0
            rss_samples.append((round(el, 1), rss_mb()))
            phase[0] = clients_at(el, args.duration, args.clients)
            if time.perf_counter() >= next_report:
                with lat_lock:
                    n = len(latencies)
                print(f"  t={el:6.0f}s reqs={n} "
                      f"rate={n / el:6.1f}/s rss={rss_samples[-1][1]:.0f}MB "
                      f"clients={phase[0]}", flush=True)
                next_report += 30.0
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        wall = time.perf_counter() - t0

    lat = np.sort(np.asarray(latencies))
    s = svc.stats
    rss_vals = [r for _, r in rss_samples]
    report = {
        "duration_s": round(wall, 1),
        "requests": int(lat.size),
        "req_per_s": round(lat.size / wall, 2),
        "latency_ms": {
            "p50": round(float(np.percentile(lat, 50)) * 1e3, 1),
            "p95": round(float(np.percentile(lat, 95)) * 1e3, 1),
            "p99": round(float(np.percentile(lat, 99)) * 1e3, 1),
            "max": round(float(lat[-1]) * 1e3, 1),
        } if lat.size else None,
        "batches": int(s.batches),
        "mean_fill": round(s.mean_batch, 2),
        "saturated_requests": int(s.saturated),
        "clients": args.clients, "max_batch": args.max_batch,
        "wire": wire.name, "img_size": S,
        "rss_mb": {"start": rss_vals[0], "end": rss_vals[-1],
                   "max": max(rss_vals),
                   "drift": round(rss_vals[-1] - rss_vals[0], 1)},
        "rss_samples": rss_samples[:: max(1, len(rss_samples) // 60)],
        "devices": device_count(det.device),
    }
    print(json.dumps({k: v for k, v in report.items()
                      if k != "rss_samples"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
