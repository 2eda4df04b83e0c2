"""Per-step sums of the program's own spans: ``<port>/utils/profiling.py:
span_records()``, the spans its training step entered since the traced
window's profiler turned on (``train.step`` and its children), each with
its host and device milliseconds. A reader sums the named spans' time and
divides by the number of ``train.step`` records; it returns None where the
program keeps no such record (a program without the spans, or a run with
no card for the device time), and the metric is then left out."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from benchmark import port

STEP = "train.step"
EOT = ("train.eot", "train.eot_bwd")
VICTIM_FWD = ("train.victim_fwd",)
VICTIM_BWD = ("train.victim_bwd",)
REST = ("train.inputs", "train.loss", "train.update")


def records() -> Optional[List[Dict]]:
    read = getattr(port.mod("utils.profiling"), "span_records", None)
    return read() if read is not None else None


def per_step(recs: Optional[List[Dict]], names: Iterable[str],
             field: str) -> Optional[float]:
    """The sum of ``field`` (``host_ms`` or ``device_ms``) over the
    records named in ``names``, over the number of ``train.step``
    records."""
    if not recs:
        return None
    names = set(names)
    steps = sum(1 for r in recs if r["name"] == STEP)
    vals = [r[field] for r in recs if r["name"] in names]
    if not steps or not vals or any(v is None for v in vals):
        return None
    return sum(vals) / steps


def eot_ms(r):
    return per_step(records(), EOT, "device_ms")


def victim_fwd_ms(r):
    return per_step(records(), VICTIM_FWD, "device_ms")


def victim_bwd_ms(r):
    return per_step(records(), VICTIM_BWD, "device_ms")


def loss_update_ms(r):
    return per_step(records(), REST, "device_ms")


def eot_host_ms(r):
    return per_step(records(), EOT, "host_ms")


def victim_host_ms(r):
    return per_step(records(), VICTIM_FWD + VICTIM_BWD, "host_ms")


def loss_update_host_ms(r):
    return per_step(records(), REST, "host_ms")
