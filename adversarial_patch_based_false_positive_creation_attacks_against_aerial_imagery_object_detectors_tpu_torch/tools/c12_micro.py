"""Kernel-level decomposition of the conv12-widened stage backward (the
repository's ``tools/c12_micro.py``): times, at the given batch, the
152^2 stage in bfloat16, each piece that the c12 route's step composes:

  - ``res152_fused`` with ``save`` (K6a: the forward and its masks, the
    same in both routes)
  - ``res152_fused_grad`` (K6b: the g11-fed saved-mask stage backward)
  - ``res152_fused_grad12`` (K6c: the g12-fed widened backward, conv12's
    stride-2 input cotangent computed in the kernel before the stage's
    chain)
  - conv12's dgrad on cuDNN (``c12_dx``: what the unwidened route pays
    beside K6b)

and prints "widened - (g11 + xla12)": K6c less K6b and the dgrad. The
weights are the repository tool's (``np.random.default_rng(0)``, scale
0.05, biases 0.01); the activations and cotangents, [24, 152, 152, 128]
and [24, 76, 76, 256] at b24, come from a ``torch.Generator`` seeded 0 on
the device (the tool's numpy draws would take seconds on the host) and go
to planar through ``to_planar`` (the tiled K3a). (The repository tool's
stripe ``S``, ``wq`` and parity pair matrix are TPU blocking; the
kernels have none.) Each series is ``ITERS`` back-to-back calls after a
warm-up between CUDA events (the host's clock on the CPU). ``--device``
defaults to cuda and raises where there is no card.

    python -m <package>.tools.c12_micro [batch]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import res_fused as RF
from ..ops._cuda import resolve_device
from ..ops.planar_conv import to_planar
from ..utils.profiling import HOST_BOUND_MS, time_calls
from .conv_micro import library_weight

H, C = 152, 128
DT = torch.bfloat16
ITERS = 20


def timed(fn, x, *rest, iters=ITERS):
    """Milliseconds of one ``fn(x, *rest)`` (``time_calls``: warm-up,
    then ``iters`` calls between CUDA events; the last result must sum
    finite)."""
    return time_calls(lambda: fn(x, *rest), iters, x.device)[0] * 1e3


def c12_dx(g, w12):
    """conv12's input cotangent on NHWC (HWIO ``w12`` [3, 3, C, 2C],
    stride 2, pad 1) for the NHWC cotangent ``g`` [B, h/2, h/2, 2C]:
    ``torch.nn.grad.conv2d_input``, cuDNN's dgrad (the repository tool's
    ``vjp`` of conv12)."""
    b, hh = g.shape[0], 2 * g.shape[1]
    return torch.nn.grad.conv2d_input(
        (b, w12.shape[2], hh, hh), w12.permute(3, 2, 0, 1),
        g.permute(0, 3, 1, 2), 2, 1).permute(0, 2, 3, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    b, dev = args.batch, resolve_device(args.device)
    rng = np.random.default_rng(0)

    def mk(shape, scale=0.05, dtype=DT):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev, dtype)

    sp = [
        (mk((1, 1, C, C // 2)), mk((C // 2,), 0.01, torch.float32)),
        (mk((3, 3, C // 2, C)), mk((C,), 0.01, torch.float32)),
        (mk((1, 1, C, C // 2)), mk((C // 2,), 0.01, torch.float32)),
        (mk((3, 3, C // 2, C)), mk((C,), 0.01, torch.float32)),
    ]
    w12 = mk((3, 3, C, 2 * C))
    fwd, bwd = RF.res_weights(sp)
    w12t = RF.res12_weights(w12)

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(DT)

    with torch.no_grad():
        xp = to_planar(rand(b, H, H, C))
        _, *masks = RF.res152_fused(xp, fwd, save=True)
        g11p = to_planar(rand(b, H, H, C))
        g12n = rand(b, H // 2, H // 2, 2 * C)
        gp12 = to_planar(g12n)

        t_fwd = timed(lambda x, ops: RF.res152_fused(x, ops, save=True)[0],
                      xp, fwd)
        t_bwd = timed(RF.res152_fused_grad, g11p, masks, bwd)
        t_bwd12 = timed(RF.res152_fused_grad12, gp12, masks, bwd, w12t)
        # cuDNN's conv12 dgrad on NHWC (what the unwidened path pays)
        t_xla12 = timed(c12_dx, g12n, library_weight(w12))

    print(f"b{b} {H}^2 stage, bf16:")
    print(f"  fused fwd (save)        {t_fwd:7.3f} ms")
    print(f"  fused bwd  g11-fed      {t_bwd:7.3f} ms")
    print(f"  fused bwd  g12-widened  {t_bwd12:7.3f} ms")
    print(f"  cuDNN conv12 dgrad      {t_xla12:7.3f} ms")
    print(f"  widened - (g11 + xla12) {t_bwd12 - t_bwd - t_xla12:+7.3f} ms")
    times = {"fwd_save_ms": t_fwd, "bwd_g11_ms": t_bwd,
             "bwd_g12_ms": t_bwd12, "conv12_dgrad_ms": t_xla12}
    return {"batch": b, "dtype": "bfloat16", "device": str(dev),
            "iters": ITERS, **times,
            "widened_minus_parts_ms": t_bwd12 - t_bwd - t_xla12,
            "host_bound": [k for k, t in times.items() if t < HOST_BOUND_MS]}


if __name__ == "__main__":
    main()
