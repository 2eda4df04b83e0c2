"""Tracing and timing helpers (the JAX package's ``utils/profiling.py``
on ``torch.profiler`` in place of ``jax.profiler``):

- ``StepTimer``: rolling step timer that synchronizes the card only at
  its report boundaries;
- ``trace``: context manager around ``torch.profiler.profile`` (host
  activity, and the card's wherever one is visible) writing a Chrome
  trace when a directory is given, a no-op otherwise;
- ``annotate``: named trace region (``torch.profiler.record_function``);
- ``time_calls``: the time of one call of a function over back-to-back
  calls (CUDA events on a card), the micro tools' timer.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Optional

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            supported_activities, tensorboard_trace_handler)


class StepTimer:
    """Rolling throughput meter. ``tick(sync_value)`` counts a step; every
    ``report_every`` steps it waits once for ``sync_value``'s card (when
    it is a CUDA tensor; a CPU tensor needs no wait) and records the
    interval."""

    def __init__(self, report_every: int = 50):
        self.report_every = report_every
        self.count = 0
        self._t0: Optional[float] = None
        self.last_steps_per_sec = 0.0

    def tick(self, sync_value=None) -> Optional[float]:
        self.count += 1
        if self.count % self.report_every:
            return None
        if isinstance(sync_value, torch.Tensor) and sync_value.is_cuda:
            torch.cuda.synchronize(sync_value.device)
        now = time.perf_counter()
        if self._t0 is not None:
            self.last_steps_per_sec = self.report_every / (now - self._t0)
        self._t0 = now
        return self.last_steps_per_sec or None


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the host and the card into ``log_dir`` (a Chrome trace,
    ``*.pt.trace.json``, written when the block ends) and yield the
    ``torch.profiler.profile``; with no directory, a no-op that yields
    None. Where a card is visible its activity is traced too, and a
    build of PyTorch that cannot trace it raises rather than hand back a
    host-only trace."""
    if not log_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("torch.profiler cannot trace the card's "
                               "activity in this build of PyTorch")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named region visible in profiler traces."""
    return record_function(name)


# a call that reads under this many ms by CUDA events is bound by the
# host's launch path, not by its kernels (K7 on one H100: 0.028 ms by
# events against 0.0086 ms of device time)
HOST_BOUND_MS = 0.05


def time_calls(fn, iters: int, device, warmup: int = 3):
    """``(seconds, out)``: the time of one ``fn()`` over ``iters``
    back-to-back calls after ``warmup`` untimed ones (the first call also
    builds the kernels), and the last call's result, a tensor. On a CUDA
    ``device`` two CUDA events bracket the calls: the card's time from
    the first launch to the end of the last kernel, the gaps in which it
    waits for the host included. Elsewhere the host's clock. ``out`` is
    then read back as one scalar, its sum, which must be finite (else
    ``FloatingPointError``)."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        out = fn()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    if cuda:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3 / iters
    else:
        seconds = (time.perf_counter() - t0) / iters
    total = float(out.float().sum())
    if not math.isfinite(total):
        raise FloatingPointError(f"a timed call's result sums to {total}")
    return seconds, out
