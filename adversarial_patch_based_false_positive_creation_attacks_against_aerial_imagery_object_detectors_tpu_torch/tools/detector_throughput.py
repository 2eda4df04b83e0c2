"""Detector inference throughput, the serving path (the repository's
``tools/detector_throughput.py``), at batch B of the full-width YOLOv3
(random weights from seed 0, bfloat16) in three lines:

1. the device pipeline: forward + decode + top-k prune
   (``Detector._infer``), input resident on the device, each call
   chained on the last one's scores;
2. end to end with host I/O and the native host NMS (``detect_batch``);
3. ``detect_batch_device``: forward, decode, threshold and the Jacobi
   device NMS. That NMS reads a flag back to the host once a pass
   (``ops/nms.py: _jacobi_alive``) and once more for its convergence, so
   this line includes those round trips: it is not a device-only time.

Each series is timed by the host's clock between two
``torch.cuda.synchronize`` calls, after a warm call; the detector
compiles nothing but its kernels. ``--device`` defaults to cuda and
raises where there is no card.

    python -m <package>.tools.detector_throughput [B]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .serving_throughput import build_detector


@torch.inference_mode()
def step(det, x):
    """One device-pipeline call chained on ``x``: the next input depends
    on this call's scores, so the calls run one after another."""
    vals = det._infer(x)   # [B, k, 8]; col 7 = score
    score = vals[..., 7]
    return x + 1e-12 * torch.mean(score), score


def _timed(dev, fn, n: int) -> float:
    """Seconds a call of ``fn`` over ``n`` calls, the device drained
    before and after."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    b = args.B
    det = build_detector(args.device)
    dev = det.device
    s = det.img_size
    imgs = np.random.default_rng(0).random((b, s, s, 3)).astype(np.float32)
    dev_imgs = torch.from_numpy(imgs).to(dev)
    rates = {}

    chain = [dev_imgs]

    def pipeline():
        chain[0], _ = step(det, chain[0])

    pipeline()
    pipeline()
    dt = _timed(dev, pipeline, 20)
    rates["device_pipeline"] = {"ms_per_batch": dt * 1e3, "img_per_s": b / dt}
    print(f"device pipeline (fwd+decode+topk): batch {b}: "
          f"{dt * 1e3:.1f} ms/batch  {b / dt:.1f} img/s")

    det.detect_batch(imgs, 0.4, 0.4)
    dt = _timed(dev, lambda: det.detect_batch(imgs, 0.4, 0.4), 5)
    rates["end_to_end"] = {"ms_per_batch": dt * 1e3, "img_per_s": b / dt}
    print(f"end-to-end incl. host I/O + NMS:   batch {b}: "
          f"{dt * 1e3:.1f} ms/batch  {b / dt:.1f} img/s")

    det.detect_batch_device(dev_imgs, 0.4, 0.4)
    dt = _timed(dev, lambda: det.detect_batch_device(dev_imgs, 0.4, 0.4), 10)
    rates["detect_batch_device"] = {"ms_per_batch": dt * 1e3,
                                    "img_per_s": b / dt}
    print(f"device detect (fwd+decode+NMS, with the NMS's host reads): "
          f"batch {b}: {dt * 1e3:.1f} ms/batch  {b / dt:.1f} img/s")
    return {"batch": b, "img_size": s, **rates}


if __name__ == "__main__":
    main()
