"""What the per-layer readers (``metrics/<metric>.py``) share: the host
counters of a window, the device's idle share and a kernel's share of
its roofline in a trace, and the model FLOP utilisation of training.
Each returns None where it finds nothing to read, and the metric is then
left out of the result."""

from __future__ import annotations

from benchmark.peaks import peak, roofline_ms
from benchmark.reference.darknet import blocks_for, conv_flops_per_image


def host_issue_ms_per_step(r):
    """Host milliseconds to issue one training step: the host clock
    around each untraced ``epoch_fn`` call, before any synchronize, over
    its steps."""
    return r.window.host.get("issue_ms_per_step")


def device_idle(r):
    """Share of the traced window in which no kernel, copy or set ran on
    the card."""
    if r.trace is None or not r.trace.ops or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def train_mfu(r):
    """The victim's conv FLOPs a real image (forward plus the input
    backward, which costs the forward's again; the EOT, losses and update
    are not counted) times the images a second of the window's untraced
    calls, over the card's bfloat16 peak."""
    rate = r.window.host.get("img_per_s")
    top = peak(r.device_name, "bf16_flops")
    if rate is None or top is None:
        return None
    cfg = r.env.config
    flops = 2.0 * conv_flops_per_image(blocks_for(cfg), cfg["img_size"])
    return 100.0 * flops * rate / top


def roofline_share(r, pattern: str, bytes_moved: float, flops: float):
    """The kernels matching ``pattern`` against their roofline: the least
    time of one launch (``peaks.roofline_ms``) times the launches traced,
    over their traced time."""
    if r.trace is None:
        return None
    seconds = r.trace.kernel_s(pattern)
    bound = roofline_ms(r.device_name, bytes_moved, flops)
    if seconds is None or bound is None:
        return None
    return 100.0 * r.trace.kernel_count(pattern) * bound[0] / (seconds * 1e3)
