"""Micro-batching detection service (the serving path).

The reference has no serving layer at all — its closest analog is the
one-image-at-a-time ``do_detect`` loop (reference utils.py:450-519,
clean_img_pre.py:52-120) that re-enters Python per image. Serving on
the card wants the opposite shape: one device program at a FIXED batch
size, fed by a micro-batcher that coalesces concurrent requests and pads the
tail. Detection runs fully on device (forward + decode + threshold +
greedy NMS, ``Detector.detect_batch_device``); only the fixed-size
``[B, 300, 7]`` result crosses back to host.

Request flow: callers (any thread) ``submit()`` an image and block on a
Future; the worker thread drains the queue — first item blocks, then up
to ``max_batch - 1`` more are gathered within ``window_ms`` — pads the
batch to ``max_batch`` with zeros, runs the one device program, and
resolves each Future with that image's valid detection rows.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ServiceStats:
    """Running counters only (a long-lived service must not grow
    per-batch state without bound)."""
    requests: int = 0
    batches: int = 0
    # requests whose NMS candidate prune saturated (see
    # Detector.detect_batch_device's pruning contract): their result is
    # a lower bound, not provably complete
    saturated: int = 0

    @property
    def mean_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0


class DetectionService:
    """Thread-safe micro-batching wrapper around a ``Detector``.

    ``max_batch`` is the compiled batch size (every device call runs at
    exactly this size); ``window_ms`` bounds how long the worker waits
    to fill a batch once the first request of a batch has arrived.
    """

    def __init__(self, detector, max_batch: int = 8,
                 window_ms: float = 5.0, conf_thresh: float = 0.4,
                 nms_thresh: float = 0.4, wire_dtype=np.float32):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.detector = detector
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self.conf_thresh = float(conf_thresh)
        self.nms_thresh = float(nms_thresh)
        # uint8 wire dtype ships 4x less over the host->device link
        # (normalization happens inside the device program); float32
        # preserves arbitrary caller-side preprocessing exactly
        self.wire_dtype = np.dtype(wire_dtype)
        if self.wire_dtype not in (np.dtype(np.float32),
                                   np.dtype(np.uint8)):
            raise ValueError(f"wire_dtype must be float32 or uint8, "
                             f"got {self.wire_dtype}")
        self.stats = ServiceStats()
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # serializes submit-enqueue against stop-drain: once _stop is set
        # under this lock no new item can enter the queue, so the
        # post-join drain in stop() provably fails every pending Future
        # (an unguarded submit racing a concurrent stop() could enqueue
        # after the drain and block its caller forever)
        self._lifecycle = threading.Lock()

    # -- lifecycle ---------------------------------------------------
    def start(self, warmup: bool = True) -> "DetectionService":
        """Start the worker thread; ``warmup`` runs the fixed-size
        batch once up front so the first request doesn't pay for kernel
        builds and allocator growth."""
        if self._worker is not None:
            raise RuntimeError("service already started")
        if warmup:
            s = self.detector.img_size
            z = np.zeros((self.max_batch, s, s, 3), self.wire_dtype)
            d, v, _sat = self.detector.detect_batch_device(
                z, self.conf_thresh, self.nms_thresh)
            _host(v)  # block until the device has run it
        self._stop.clear()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="detect-batcher")
        self._worker.start()
        return self

    def stop(self) -> None:
        with self._lifecycle:
            if self._worker is None:
                return
            self._stop.set()  # from here on submit() raises, no new items
            self._queue.put(None)  # wake the worker
        self._worker.join()
        self._worker = None
        # fail whatever the worker left behind; nothing can arrive later
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("service stopped"))

    def __enter__(self) -> "DetectionService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request side ------------------------------------------------
    def submit(self, image: np.ndarray, timeout: Optional[float] = None,
               return_saturated: bool = False):
        """Detect on one [S, S, 3] image — float in [0, 1] or uint8 in
        [0, 255]. Blocks until the batch containing this request
        completes; returns the [N, 7] rows
        (x, y, w, h, obj, cls_conf, cls_id), normalized — or, with
        ``return_saturated=True``, ``(rows, saturated)`` where
        ``saturated`` flags that the device NMS's candidate prune
        overflowed for this image (the rows are then a lower bound —
        see ``Detector.detect_batch_device``). Saturated requests are
        also counted in ``stats.saturated``.

        The image is shipped in ``wire_dtype``: with a uint8 wire a
        float input is quantized to 1/255 steps (and a uint8 input
        passes through exactly); with a float32 wire a uint8 input is
        divided by 255 on the host."""
        s = self.detector.img_size
        image = np.asarray(image)
        if image.shape != (s, s, 3):
            raise ValueError(
                f"expected [{s}, {s}, 3] image, got {image.shape}")
        if self.wire_dtype == np.uint8:
            if image.dtype != np.uint8:
                image = np.clip(np.asarray(image, np.float32) * 255.0
                                + 0.5, 0, 255).astype(np.uint8)
        else:
            if image.dtype == np.uint8:
                image = image.astype(np.float32) / 255.0
            else:
                image = np.asarray(image, np.float32)
        fut: Future = Future()
        with self._lifecycle:
            if self._worker is None or self._stop.is_set():
                raise RuntimeError("service not started")
            self._queue.put((image, fut))
        rows, saturated = fut.result(timeout=timeout)
        return (rows, saturated) if return_saturated else rows

    # -- worker side -------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            item = self._queue.get()
            if item is None:
                continue
            batch = [item]
            deadline = _now() + self.window_s
            while len(batch) < self.max_batch:
                remaining = deadline - _now()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            self._process(batch)

    def _process(self, batch) -> None:
        images = np.stack([img for img, _ in batch])
        n = images.shape[0]
        if n < self.max_batch:
            pad = np.zeros((self.max_batch - n,) + images.shape[1:],
                           images.dtype)
            images = np.concatenate([images, pad])
        try:
            dets, valid, saturated = self.detector.detect_batch_device(
                images, self.conf_thresh, self.nms_thresh)
            dets = _host(dets)
            valid = _host(valid)
            saturated = _host(saturated)
        except Exception as e:  # resolve every waiter, never deadlock
            for _, fut in batch:
                fut.set_exception(e)
            return
        self.stats.requests += n
        self.stats.batches += 1
        self.stats.saturated += int(saturated[:n].sum())
        for i, (_, fut) in enumerate(batch):
            fut.set_result((dets[i][valid[i].astype(bool)],
                            bool(saturated[i])))


def _host(t) -> np.ndarray:
    """A detector result (a device tensor) as a host array."""
    return t.cpu().numpy()


def _now() -> float:
    import time
    return time.monotonic()
