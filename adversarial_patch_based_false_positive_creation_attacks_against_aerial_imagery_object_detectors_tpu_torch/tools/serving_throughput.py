"""Serving-path load test (the repository's ``tools/serving_throughput.py``):
sustained throughput of the micro-batching ``DetectionService``
(``evals/serving.py``) under concurrent request pressure, bypassing HTTP
(in-process callers) so the number reflects the batcher and the device
pipeline, not socket overhead.

The detector is the full-width YOLOv3 (``yolov3_blocks()``, random
weights from seed 0, bfloat16; on a card its stem runs K3a
``split_phases``, K1 and K3b); one warm request, then ``n_requests``
from ``n_clients`` threads. The clock is the host's, read after the
last request's result has come back to the host (each result crosses
to the host, so no device work is left outstanding). The detector
compiles nothing but its kernels (built at first use). ``--device``
defaults to cuda and raises where there is no card.

    python -m <package>.tools.serving_throughput [n_requests] [max_batch]
        [n_clients] [wire_dtype]

(wire_dtype: float32 | uint8; uint8 ships 4x less host -> device.)
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..evals import Detector
from ..evals.serving import DetectionService
from ..models import build_network, fold_bn, init_params, yolov3_blocks
from ..ops._cuda import resolve_device


IMG = 608


def build_detector(device) -> Detector:
    """The bfloat16 ``Detector`` the serving tools measure: the full-width
    YOLOv3 at 608^2, random weights from seed 0, on ``device``."""
    net = build_network(yolov3_blocks())
    return Detector(net, fold_bn(net, init_params(net, 0)), img_size=IMG,
                    device=resolve_device(device))


def device_count(dev: torch.device) -> int:
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_requests", nargs="?", type=int, default=64)
    ap.add_argument("max_batch", nargs="?", type=int, default=8)
    ap.add_argument("n_clients", nargs="?", type=int, default=16)
    ap.add_argument("wire_dtype", nargs="?", default="float32",
                    choices=["float32", "uint8"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    n_req, max_b, clients = args.n_requests, args.max_batch, args.n_clients
    wire = np.dtype(args.wire_dtype)
    det = build_detector(args.device)
    svc = DetectionService(det, max_batch=max_b, window_ms=10.0,
                           conf_thresh=0.4, nms_thresh=0.4, wire_dtype=wire)
    rng = np.random.default_rng(0)
    s = det.img_size
    if wire == np.uint8:
        imgs = [rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
                for _ in range(min(n_req, 8))]
    else:
        imgs = [rng.random((s, s, 3)).astype(np.float32)
                for _ in range(min(n_req, 8))]
    with svc:
        # warm the pool + service once
        svc.submit(imgs[0])
        t0 = time.perf_counter()
        with ThreadPoolExecutor(clients) as pool:
            list(pool.map(lambda i: svc.submit(imgs[i % len(imgs)]),
                          range(n_req)))
        dt = time.perf_counter() - t0
    st = svc.stats
    devices = device_count(det.device)
    print(f"served {n_req} reqs in {dt:.2f}s = {n_req / dt:.1f} img/s "
          f"({st.batches} batches, mean fill {st.mean_batch:.1f}/{max_b}, "
          f"{clients} clients, wire={wire.name}, devices={devices})")
    return {"n_requests": n_req, "served": st.requests, "seconds": dt,
            "img_per_s": n_req / dt, "batches": st.batches,
            "mean_fill": st.mean_batch, "max_batch": max_b,
            "clients": clients, "wire": wire.name, "devices": devices}


if __name__ == "__main__":
    main()
