"""A/B of the YOLOv3 stem (layers 0-5) forward and forward + backward
(the repository's ``tools/stem_ab.py``): the stem as cuDNN convs
(``xla_stem``, autograd for its backward) against the planar stem
(``models/stem_planar.py: planar_stem``, K3a -> K4 x 5 -> K3b, its hand
backward on K4), then the planar backward timed piece by piece.

The pieces are the port's chain (``models/stem_planar.py: _stem_bwd``),
each timed on its own input, which is the previous piece's output. The
repository tool's "expand2@152 + conv5-dx K384" and "expand2@304 +
conv1-dx K192+gate" pairs are each one K4 ``k3t2`` launch here
(``planar_conv_t2``, the stride-2 adjoint on the unexpanded cotangent),
and the chain ends with ``from_planar`` (K3b's narrow form) as
``_stem_bwd`` does; "sum" is the sum of the pieces. The tool also holds
the chain's last output against ``_stem_bwd`` on the same inputs (the
same kernels: the count of differing elements must be 0). Weights and
inputs are the repository tool's (``np.random.default_rng(0)``), in
bfloat16. Each series is ``ITERS`` back-to-back calls after a warm-up
between CUDA events (the host's clock on the CPU). ``--device`` defaults
to cuda and raises where there is no card.

    python -m <package>.tools.stem_ab [batch] [h]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..models.stem_planar import (_forward, _stem_bwd, planar_stem,
                                  planar_stem_params)
from ..ops._cuda import resolve_device
from ..ops.planar_conv import (flip_t, from_planar, leaky_bwd_planar,
                               pad_cout, planar_conv, planar_conv_t2,
                               to_planar)
from ..ops.stem_fused import STEM_FILTERS, STEM_IN, STEM_KSIZE
from ..utils.profiling import HOST_BOUND_MS, time_calls

DT = torch.bfloat16
ITERS = 20
# (cin, cout, k) of convs 0, 1, 2, 3 and 5
STEM = tuple(zip(STEM_IN, STEM_FILTERS, STEM_KSIZE))


def stem_inputs(b, h, dev):
    """The repository tool's stem weights (HWIO in bfloat16, float32
    biases) and input x0 [b, h, h, 3], from ``np.random.default_rng(0)``
    in its order; the generator is returned for the draws that follow."""
    rng = np.random.default_rng(0)
    sp = []
    for cin, cout, k in STEM:
        sp.append((torch.from_numpy(rng.standard_normal(
            (k, k, cin, cout)) * 0.05).to(dev, DT),
            torch.from_numpy(rng.standard_normal(cout) * 0.01).to(
                dev, torch.float32)))
    x0 = torch.from_numpy(rng.random((b, h, h, 3))).to(dev, DT)
    return sp, x0, rng


def timed(fn, x, iters=ITERS):
    """Seconds of one ``fn(x)`` (``time_calls``: warm-up, then ``iters``
    calls between CUDA events; the last result must sum finite)."""
    return time_calls(lambda: fn(x), iters, x.device)[0]


def xla_stem(v, sp):
    """Layers 0-5 as cuDNN convs on NHWC ``v`` (``channels_last``
    views), each conv's bias added and leaky applied in v's dtype, as the
    repository tool's XLA stem: NHWC y5."""
    def conv(u, w, b, s):
        y = F.conv2d(u, w.to(u.dtype).permute(3, 2, 0, 1), None, s,
                     (w.shape[0] - 1) // 2)
        y = y + b.to(y.dtype).view(1, -1, 1, 1)
        return torch.where(y > 0, y, 0.1 * y)
    u = v.permute(0, 3, 1, 2)
    y0 = conv(u, *sp[0], 1)
    y1 = conv(y0, *sp[1], 2)
    y2 = conv(y1, *sp[2], 1)
    y3 = conv(y2, *sp[3], 1)
    return conv(y3 + y1, *sp[4], 2).permute(0, 2, 3, 1)


def loss_xla(v, sp):
    return xla_stem(v, sp).float().sum()


def loss_planar(v, fwd, bwd):
    return planar_stem(v, fwd, bwd).float().sum()


def input_grad(loss, x, *params):
    """The input cotangent of ``loss(x, *params)`` by autograd."""
    v = x.detach().requires_grad_(True)
    return torch.autograd.grad(loss(v, *params), v)[0]


def zb(w):
    """The zero float32 bias of a backward conv with weight ``w``."""
    return torch.zeros(w.shape[-1], dtype=torch.float32, device=w.device)


def chain(acts, g5, sp, h):
    """The planar backward's pieces, as ``_stem_bwd`` chains them: a list
    of (label, fn, input), each input the previous piece's output (run
    here once), and the last piece's output (NHWC gx). The backward
    weights are the repository tool's: ``flip_t`` of the forward ones
    (conv0's also ``pad_cout``), with zero biases."""
    y0, y1, y2, y3, y5 = acts
    wt = [flip_t(w) for w, _ in sp]
    wt[0] = pad_cout(wt[0])
    w0t, w1t, w2t, w3t, w5t = (w.contiguous() for w in wt)
    z0, z1, z2, z3, z5 = (zb(w) for w in (w0t, w1t, w2t, w3t, w5t))
    gp5 = leaky_bwd_planar(to_planar(g5), y5)
    g_sc = planar_conv_t2(gp5, w5t, z5, w_img=h // 4)
    gp3 = leaky_bwd_planar(g_sc, y3)
    gp2 = planar_conv(gp3, w3t, z3, k=3, slope=None, gate=y2)
    gp1 = planar_conv(gp2, w2t, z2, res=g_sc, k=1, slope=None, gate=y1)
    gp0 = planar_conv_t2(gp1, w1t, z1, w_img=h // 2, gate=y0)
    gx0 = planar_conv(gp0, w0t, z0, k=3, slope=None)
    pieces = [
        ("mask5+to_planar",
         lambda g: leaky_bwd_planar(to_planar(g), y5), g5),
        (f"k3t2@{h // 4} (expand2@{h // 4} + conv5-dx K384)",
         lambda g: planar_conv_t2(g, w5t, z5, w_img=h // 4), gp5),
        ("mask3", lambda g: leaky_bwd_planar(g, y3), g_sc),
        ("conv3-dx+gate",
         lambda g: planar_conv(g, w3t, z3, k=3, slope=None, gate=y2), gp3),
        ("conv2-dx k1+res+gate",
         lambda g: planar_conv(g, w2t, z2, res=g_sc, k=1, slope=None,
                               gate=y1), gp2),
        (f"k3t2@{h // 2}+gate (expand2@{h // 2} + conv1-dx K192+gate)",
         lambda g: planar_conv_t2(g, w1t, z1, w_img=h // 2, gate=y0), gp1),
        ("conv0-dx",
         lambda g: planar_conv(g, w0t, z0, k=3, slope=None), gp0),
        ("from_planar (narrow)", lambda g: from_planar(g, h, 3), gx0),
    ]
    return pieces, from_planar(gx0, h, 3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("h", nargs="?", type=int, default=608)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    b, h, dev = args.batch, args.h, resolve_device(args.device)
    sp, x0, rng = stem_inputs(b, h, dev)
    fwd, bwd = planar_stem_params(sp)
    print(f"batch={b} H={h} dev={dev}", flush=True)
    rows = {}

    def row(label, fn):
        rows[label] = timed(fn, x0) * 1e3
        print(f"{label:16s}: {rows[label]:7.2f} ms", flush=True)

    with torch.no_grad():
        row("cuDNN  fwd", lambda v: xla_stem(v, sp))
        row("planar fwd", lambda v: planar_stem(v, fwd))
    row("cuDNN  fwd+bwd", lambda v: input_grad(loss_xla, v, sp))
    row("planar fwd+bwd", lambda v: input_grad(loss_planar, v, fwd, bwd))

    # --- per-piece (planar backward), each on its own input
    with torch.no_grad():
        acts = _forward(x0, fwd)
        g5 = torch.from_numpy(rng.random((b, h // 4, h // 4, 128))).to(
            dev, DT)
        pieces, gx = chain(acts, g5, sp, h)
        differing = int((gx != _stem_bwd(acts, g5, bwd, h)).sum())
        total, piece_ms = 0.0, {}
        for name, f, arg in pieces:
            piece_ms[name] = timed(f, arg) * 1e3
            total += piece_ms[name]
            print(f"{name:52s}: {piece_ms[name]:7.2f} ms", flush=True)
    print(f"{'sum':52s}: {total:7.2f} ms")
    print(f"chain vs _stem_bwd: {differing} elements differ")
    return {"batch": b, "h": h, "dtype": "bfloat16", "device": str(dev),
            "iters": ITERS, "ms": rows, "pieces_ms": piece_ms,
            "pieces_sum_ms": total, "chain_vs_stem_bwd_differing": differing,
            "host_bound": [k for k, t in {**rows, **piece_ms}.items()
                           if t < HOST_BOUND_MS]}


if __name__ == "__main__":
    main()
