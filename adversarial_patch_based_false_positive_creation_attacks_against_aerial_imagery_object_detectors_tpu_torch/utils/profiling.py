"""Tracing and timing helpers (the JAX package's ``utils/profiling.py``
on ``torch.profiler`` in place of ``jax.profiler``):

- ``StepTimer``: rolling step timer that synchronizes the card only at
  its report boundaries;
- ``trace``: context manager around ``torch.profiler.profile`` (host
  activity, and the card's wherever one is visible) writing a Chrome
  trace when a directory is given, a no-op otherwise;
- ``annotate``: named trace region (``torch.profiler.record_function``);
- ``span``: the program's own named region, an ``annotate`` that also
  keeps a record (host clock, CUDA events) while a profiler is on, and
  costs one flag read while none is; ``span_records`` reads the records;
- ``time_calls``: the time of one call of a function over back-to-back
  calls (CUDA events on a card), the micro tools' timer.

The training step (``train/trainer.py``) runs under spans: ``train.step``
around each step, and inside it ``train.inputs`` (the batch and its EOT
draws), ``train.eot`` (median, jitter, warp, composite), ``train.victim_fwd``,
``train.loss``, ``train.backward`` (split in the records, not in the
trace, into ``train.victim_bwd`` and ``train.eot_bwd`` where the gradient
reaches the victim's input) and ``train.update``. To read them, run
training inside ``trace(dir)`` (or any ``torch.profiler.profile``): the
Chrome trace holds the ``train.*`` regions on the card's clock, and
``span_records()``, called after the profiled block, gives each span's
host and device milliseconds::

    with trace("runs/prof"):
        trainer.train_store(store, epochs=1)
    rows = span_records()      # [{"name": "train.step", "host_ms": ...}, ...]
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional, Tuple

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
    _SPANS.on = False
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named region visible in profiler traces."""
    return record_function(name)


# spans kept a profiler session (4 s of the 416² b24 training step make
# ≈ 650); later spans still reach the trace, unrecorded
MAX_SPANS = 1 << 16

# whether a profiler is on, so that spans record: under a µs a call, where
# entering and leaving a record_function costs ≈ 13 µs with none on
recording = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "parent", "step", "t0", "t1", "e0", "e1", "cut")

    def __init__(self, name, parent, step):
        self.name, self.parent, self.step = name, parent, step
        self.t1 = self.e0 = self.e1 = self.cut = None


class _Spans:
    """The records of the spans entered since the profiler last turned
    on. Spans nest on one thread; ``cut`` may come from another (an
    autograd hook) while that thread waits inside the innermost span."""

    def __init__(self):
        self.on = False
        self.records: List[_Record] = []
        self.stack: List[_Record] = []
        self.step = 0
        self.cuda = False

    def event(self):
        if not self.cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self):
        """The first span after the profiler turned on: the records of
        the session before go."""
        self.on = True
        self.records, self.stack, self.step = [], [], 0
        self.cuda = torch.cuda.is_initialized()

    @contextlib.contextmanager
    def live(self, name: str, split: Optional[Tuple[str, str]]):
        parent = self.stack[-1] if self.stack else None
        if parent is None:
            self.step += 1
        rec = _Record(name, parent, self.step)
        if len(self.records) < MAX_SPANS:
            self.records.append(rec)
        self.stack.append(rec)
        # the record brackets the annotation, whose cost then falls inside
        # the span and not between a parent's children
        rec.t0, rec.e0 = time.perf_counter(), self.event()
        try:
            with annotate(name):
                yield
        finally:
            rec.e1, rec.t1 = self.event(), time.perf_counter()
            # (a profiler turned off and on inside the span cleared it)
            if self.stack and self.stack[-1] is rec:
                self.stack.pop()
        if split is not None and rec.cut is not None:
            t, e = rec.cut
            for part, ends in ((split[0], (rec.t0, rec.e0, t, e)),
                               (split[1], (t, e, rec.t1, rec.e1))):
                if len(self.records) < MAX_SPANS:
                    child = _Record(part, rec, rec.step)
                    child.t0, child.e0, child.t1, child.e1 = ends
                    self.records.append(child)


_SPANS = _Spans()


def span(name: str, split: Optional[Tuple[str, str]] = None):
    """The program's named region. With no profiler on, one shared no-op
    context: nothing is allocated and no ``record_function`` entered.
    With one on, ``annotate(name)`` (the region in the trace, on the
    profiler's clock) and a record: its name, its parent span (the
    innermost one open), the ordinal of its step (a span with no parent
    opens a new one), host start and end (``time.perf_counter``) and,
    where the process uses a card, a CUDA event at each end on the
    current stream. Records are cleared at the first span after the
    profiler turns on (as a span or ``trace`` sees it) or after
    ``span_records`` read them, and held to ``MAX_SPANS``.

    ``split=(first, second)``: where ``cut()`` was called inside the
    span, two child records, ``first`` from the span's start to the cut
    and ``second`` from the cut to its end (the trace shows the span
    whole)."""
    if not recording():
        _SPANS.on = False
        return _OFF
    if not _SPANS.on:
        _SPANS.start()
    return _SPANS.live(name, split)


def cut(_grad=None) -> None:
    """Mark a boundary inside the innermost open span (one with a
    ``split``): the host time and a CUDA event on the calling thread's
    current stream. Its signature is a tensor hook's, and it leaves the
    gradient as it is, so a backward can be cut where a tensor's gradient
    is ready: ``tensor.register_hook(cut)``, which runs on autograd's
    thread while the spans' thread waits in ``backward()``."""
    if _SPANS.on and _SPANS.stack:
        _SPANS.stack[-1].cut = (time.perf_counter(), _SPANS.event())


def span_records() -> List[Dict]:
    """The spans closed since the profiler last turned on, in the order
    they opened: ``name``, ``parent`` (the parent's name, or None),
    ``step``, ``host_start`` and ``host_end`` (s, ``time.perf_counter``),
    ``host_ms``, and ``device_ms``, the card's time between the span's
    two events (its work and the idle time in which it waited on the
    host for the span's launches), None without a card. Synchronizes
    the card once. The next span under a profiler starts afresh."""
    _SPANS.on = False
    done = [r for r in _SPANS.records if r.t1 is not None]
    if any(r.e1 is not None for r in done):
        torch.cuda.synchronize()
    return [{"name": r.name,
             "parent": r.parent.name if r.parent is not None else None,
             "step": r.step, "host_start": r.t0, "host_end": r.t1,
             "host_ms": 1e3 * (r.t1 - r.t0),
             "device_ms": (r.e0.elapsed_time(r.e1) if r.e0 is not None
                           else None)}
            for r in done]


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
