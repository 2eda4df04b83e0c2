"""The traced part of a run: ``torch.profiler`` over a window that ends
with a synchronize, its Chrome trace written under ``TMPDIR``, read back
and deleted.

``device_intervals`` merges the card's kernels, copies and sets inside
the window (the port's ``tools/step_profile.py`` arithmetic, copied);
``busy_s`` is their union; ``kernel_s`` sums the time of the kernels
whose names match a pattern; ``breakdown`` gives the ten operations with
the most device time and the ten longest idle gaps, each under the host
operation that was running across it (a CUDA call or an annotation: the
profiler records no other host function, ``Tracer``).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME = 160     # characters of an operation's name in the breakdown


@dataclass
class Trace:
    window: Tuple[float, float]           # us
    ops: List[Tuple[float, float, str]]   # device ops clipped to it
    merged: List[List[float]]
    host: List[Tuple[float, float, str]]  # host ops overlapping it

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged) / 1e6

    def kernel_s(self, pattern: str) -> Optional[float]:
        """Seconds of the kernels whose name matches ``pattern`` (a
        regular expression searched in the name), None where none ran."""
        rx = re.compile(pattern)
        hits = [e - s for s, e, n in self.ops if rx.search(n)]
        return sum(hits) / 1e6 if hits else None

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for _, _, n in self.ops if rx.search(n))

    def breakdown(self, n: int = 10) -> dict:
        by_op = collections.Counter()
        for s, e, name in self.ops:
            by_op[name] += (e - s) / 1e6
        gaps = []
        lo = self.window[0]
        for s, e in self.merged + [[self.window[1], self.window[1]]]:
            if s > lo:
                gaps.append((lo, s))
            lo = max(lo, e)
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        gaps = gaps[:n * 5]
        host = sorted(self.host)
        starts = [h[0] for h in host]
        idle = collections.Counter()
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            # the innermost host op running at the gap's middle, among
            # the last 20,000 to start before it
            k = bisect.bisect_right(starts, mid)
            over = [h for h in host[max(0, k - 20000):k] if h[1] >= mid]
            name = (min(over, key=lambda h: h[1] - h[0])[2] if over
                    else "(no host op)")
            idle[name] += (g1 - g0) / 1e6
        return {"device_ops": [[k[:NAME], v] for k, v in by_op.most_common(n)],
                "idle_gaps": [[k[:NAME], v] for k, v in idle.most_common(n)]}


def device_intervals(events, window):
    """(merged busy intervals, [(start, end, name)]) of the device's
    operations inside ``window`` (start, end in us)."""
    lo, hi = window
    ops = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi), e["name"])
                 for e in events
                 if e.get("cat") in DEVICE_CATS
                 and e["ts"] < hi and e["ts"] + e["dur"] > lo)
    merged: List[List[float]] = []
    for s, e, _ in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged, ops


def parse(events) -> Trace:
    marks = [e for e in events if e.get("name") == WINDOW
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    m = marks[0]
    window = (float(m["ts"]), float(m["ts"]) + float(m["dur"]))
    merged, ops = device_intervals(events, window)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events
            if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")
            and e.get("ph") == "X" and e["ts"] < window[1]
            and e["ts"] + e["dur"] > window[0]]
    return Trace(window, ops, merged, host)


class Tracer:
    """``warm()`` (in set-up) profiles one short operation, so that
    the window's does not pay the profiler's first start; ``start()``
    opens the profiler after a synchronize, so that every device
    operation from then on is in the trace; ``open()`` opens the window's
    annotation, which a loop calls as it issues its next call, with the
    device busy again; ``stop()`` synchronizes, closes both, and keeps
    the profile; ``read()`` (after the measured window) exports the
    Chrome trace under ``TMPDIR``, parses it and deletes it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.mark = None
        self.trace: Optional[Trace] = None
        self.t_stop = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _enter(self):
        """A profiler, entered, that records the card's operations and
        the host's CUDA calls, and of the host's functions only the
        annotations (``record_function``): recording every aten call
        costs the host microseconds a call, and a step makes thousands,
        so a step that the card paces would read as paced by the host."""
        import torch.autograd.profiler as autograd_profiler
        from torch._C._profiler import RecordScope
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        enable = autograd_profiler._enable_profiler
        autograd_profiler._enable_profiler = (
            lambda config, activities: enable(config, activities,
                                              {RecordScope.USER_SCOPE}))
        try:
            prof.__enter__()
        finally:
            autograd_profiler._enable_profiler = enable
        return prof

    def warm(self):
        prof = self._enter()
        with torch.profiler.record_function(WINDOW):
            torch.ones(1024, device=self.device).sum().item()
        prof.__exit__(None, None, None)

    def start(self):
        self._sync()
        self.prof = self._enter()

    def open(self):
        self.mark = torch.profiler.record_function(WINDOW)
        self.mark.__enter__()

    def stop(self):
        self._sync()
        self.t_stop = time.perf_counter()
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t_stop is None

    def read(self) -> Optional[Trace]:
        if self.prof is None:
            return None
        tmp = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.prof = None
        self.trace = parse(events)
        return self.trace

