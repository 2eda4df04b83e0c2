"""Per-layer conv micro-benchmark on the current device (the repository's
``tools/conv_micro.py``).

Times the bfloat16 forward and the input gradient (the patch-attack
backward only needs dL/dx, never dL/dW) of each distinct conv shape in
the YOLOv3-DOTA front end, plus representative residual-tower shapes, on
the library: ``F.conv2d`` forward and ``torch.nn.grad.conv2d_input``
(cuDNN's dgrad alone, no weight gradient), on NHWC data as
``channels_last`` with the weight in the layout cuDNN's NHWC kernels read
(``library_weight``). It launches no kernel
of the port. Inputs and weights come from a ``torch.Generator`` seeded 0
on the device. Each series is ``ITERS`` back-to-back calls after a
warm-up, timed by CUDA events (the host's clock on the CPU); a row under
``HOST_BOUND_MS`` a call is listed under ``host_bound`` in the summary:
the host's launch path, not the conv, sets its time. ``--device``
defaults to cuda and raises where there is no card.

    python -m <package>.tools.conv_micro [batch]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ..ops._cuda import resolve_device
from ..utils.profiling import HOST_BOUND_MS, time_calls

DT = torch.bfloat16
ITERS = 30
# (name, H, Cin, Cout, k, stride)
SHAPES = (
    ("conv0  608^2 3->32 k3s1", 608, 3, 32, 3, 1),
    ("conv1  608^2 32->64 k3s2", 608, 32, 64, 3, 2),
    ("conv2  304^2 64->32 k1s1", 304, 64, 32, 1, 1),
    ("conv3  304^2 32->64 k3s1", 304, 32, 64, 3, 1),
    ("conv5  304^2 64->128 k3s2", 304, 64, 128, 3, 2),
    ("res152 152^2 128->128 k3", 152, 128, 128, 3, 1),
    ("res76  76^2 256->256 k3", 76, 256, 256, 3, 1),
    ("res38  38^2 512->512 k3", 38, 512, 512, 3, 1),
)


def library_weight(w: torch.Tensor) -> torch.Tensor:
    """An HWIO weight as an HWIO view of an OIHW ``channels_last``
    tensor: the layout cuDNN's NHWC kernels read, so ``conv`` and
    ``conv_dx`` pass it on without a copy."""
    return w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last).permute(2, 3, 1, 0)


def conv(x, w, stride):
    """NHWC ``x``, HWIO ``w`` -> NHWC: ``F.conv2d`` with the JAX tool's
    padding ((k - 1) // 2 each side) on the ``channels_last`` views."""
    pad = (w.shape[0] - 1) // 2
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                    stride, pad).permute(0, 2, 3, 1)


def conv_dx(g, w, stride, x_shape):
    """The input cotangent of ``conv`` (NHWC ``x_shape``) for the NHWC
    output cotangent ``g``: ``torch.nn.grad.conv2d_input``, cuDNN's dgrad
    alone (the JAX tool's ``vjp`` with respect to x)."""
    b, h, wd, c = x_shape
    pad = (w.shape[0] - 1) // 2
    return torch.nn.grad.conv2d_input(
        (b, c, h, wd), w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2),
        stride, pad).permute(0, 2, 3, 1)


def timed(fn, x, iters=ITERS):
    """Seconds of one ``fn(x)`` (``time_calls``: warm-up, then ``iters``
    calls between CUDA events; the last result must sum finite)."""
    return time_calls(lambda: fn(x), iters, x.device)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    b, dev = args.batch, resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"batch={b} dtype=bfloat16 dev={dev}")
    rows, host_bound = [], []
    total_f = total_g = 0.0
    for name, h, cin, cout, k, s in SHAPES:
        # contiguous NHWC: its NCHW view is channels_last
        x = torch.randn(b, h, h, cin, generator=gen, device=dev).to(DT)
        w = library_weight((torch.randn(k, k, cin, cout, generator=gen,
                                        device=dev) * 0.1).to(DT))
        tf = timed(lambda v: conv(v, w, s), x)
        # input-grad only (patch-only backprop)
        ho = h // s
        cot = torch.randn(b, ho, ho, cout, generator=gen, device=dev).to(DT)
        tg = timed(lambda g: conv_dx(g, w, s, x.shape), cot)

        flops = 2 * b * ho * ho * cout * cin * k * k
        print(f"{name:28s} fwd {tf*1e3:7.3f} ms ({flops/tf/1e12:5.1f} TF/s)"
              f"   dx {tg*1e3:7.3f} ms ({flops/tg/1e12:5.1f} TF/s)")
        rows.append({"name": name, "fwd_ms": tf * 1e3, "dx_ms": tg * 1e3,
                     "fwd_tflops": flops / tf / 1e12,
                     "dx_tflops": flops / tg / 1e12, "gflop": flops / 1e9})
        host_bound += [f"{name} {col}" for col, t in (("fwd", tf), ("dx", tg))
                       if t * 1e3 < HOST_BOUND_MS]
        total_f += tf
        total_g += tg
        del x, w, cot
    print(f"{'sum':28s} fwd {total_f*1e3:7.3f} ms"
          f"            dx {total_g*1e3:7.3f} ms")
    return {"batch": b, "dtype": "bfloat16", "device": str(dev),
            "iters": ITERS, "rows": rows, "sum_fwd_ms": total_f * 1e3,
            "sum_dx_ms": total_g * 1e3, "host_bound": host_bound}


if __name__ == "__main__":
    main()
