"""A/B of the stride-2 conv's input cotangent (the repository's
``tools/s2dx_poly_ab.py``): the library's adjoint against the polyphase
decomposition (four half-resolution parity classes, then a
depth-to-space interleave), at the five stride-2 convs of darknet-53.

The library's adjoint (``s2dx_xla``) is the input half of ``F.conv2d``'s
autograd backward, ``torch.nn.grad.conv2d_input`` (cuDNN's dgrad). The
polyphase form computes each output-parity class with its own sub-kernel
(1x1 / 1x2 / 2x1 / 2x2 taps) at half resolution, exactly the forward's
FLOPs: as ``torch.einsum`` per tap (``s2dx_poly``) or as one ``F.conv2d``
per class (``s2dx_poly_conv``). All three read the batch from the
cotangent. Each case first holds both polyphase forms against the
library's adjoint in float32 with TF32 off (max |err| over max |want|),
then times the three in bfloat16: ``ITERS`` back-to-back calls after a
warm-up between CUDA events (the host's clock on the CPU). Weights and
cotangents from ``np.random.default_rng(0)``, as the repository tool's.
It launches no kernel of the port (its answer to this adjoint, K4's
``planar_conv_t2``, is held beside ``F.conv_transpose2d`` by
``chip_smoke.py`` phase 7). ``--device`` defaults to cuda and raises
where there is no card.

    python -m <package>.tools.s2dx_poly_ab [batch]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..ops._cuda import no_tf32, resolve_device
from ..utils.profiling import HOST_BOUND_MS, time_calls

DT = torch.bfloat16
ITERS = 20


def conv_s2(x, w):
    """NHWC ``x``, HWIO ``w`` -> NHWC: the 3x3 stride-2 conv, pad 1."""
    return F.conv2d(x.permute(0, 3, 1, 2),
                    w.to(x.dtype).permute(3, 2, 0, 1), None, 2,
                    1).permute(0, 2, 3, 1)


def s2dx_xla(g, w, xshape):
    """The library's adjoint of ``conv_s2`` (what autograd runs for
    ``F.conv2d``'s input: ``torch.nn.grad.conv2d_input``, cuDNN's dgrad)
    at NHWC ``xshape`` (its batch is g's)."""
    h, wd, cin = xshape[1], xshape[2], xshape[3]
    return torch.nn.grad.conv2d_input(
        (g.shape[0], cin, h, wd), w.to(g.dtype).permute(3, 2, 0, 1),
        g.permute(0, 3, 1, 2), 2, 1).permute(0, 2, 3, 1)


def _interleave(ee, eo, oe, oo, h, wd):
    """The four parity classes [B, Ha, Wa, C] -> NHWC [B, h, wd, C]."""
    b, ha, wa, c = ee.shape
    even = torch.stack([ee, eo], dim=3).reshape(b, ha, 2 * wa, c)
    odd = torch.stack([oe, oo], dim=3).reshape(b, ha, 2 * wa, c)
    out = torch.stack([even, odd], dim=2).reshape(b, 2 * ha, 2 * wa, c)
    return out[:, :h, :wd]


def s2dx_poly(g, w, xshape):
    """Polyphase adjoint.

    fwd: y[i,j] = sum_{dy,dx} w[dy,dx] x[2i+dy-1, 2j+dx-1]  (pad 1)
    adj: dx[2a+rp, 2b+rq] uses dy with (rp+1-dy) even, i=(2a+rp+1-dy)/2:
      rp=0: dy=1, i=a
      rp=1: dy=0 -> i=a+1 ; dy=2 -> i=a
    and the same for columns. Each parity class is a small conv of g
    (padded by 1 at the high edge) with transposed taps: here one
    ``torch.einsum`` per tap in g's dtype, the taps summed in float32
    (the JAX tool's ``preferred_element_type``)."""
    wt = w.to(g.dtype)

    def tap(dy, dx, ga):
        # contract channels: ga [B,Ha,Wa,cout] @ w[dy,dx,cin,cout]^T
        return torch.einsum("bhwo,io->bhwi", ga, wt[dy, dx]).float()

    gp = F.pad(g, (0, 0, 0, 1, 0, 1))
    g00 = gp[:, :-1, :-1]   # g[a, b]
    g01 = gp[:, :-1, 1:]    # g[a, b+1]
    g10 = gp[:, 1:, :-1]    # g[a+1, b]
    g11 = gp[:, 1:, 1:]     # g[a+1, b+1]

    ee = tap(1, 1, g00)                      # dx[2a, 2b]
    eo = tap(1, 0, g01) + tap(1, 2, g00)     # dx[2a, 2b+1]
    oe = tap(0, 1, g10) + tap(2, 1, g00)     # dx[2a+1, 2b]
    oo = (tap(0, 0, g11) + tap(0, 2, g10)
          + tap(2, 0, g01) + tap(2, 2, g00))  # dx[2a+1, 2b+1]
    return _interleave(ee, eo, oe, oo, xshape[1], xshape[2]).to(g.dtype)


def s2dx_poly_conv(g, w, xshape):
    """The same math, each parity class as one ``F.conv2d`` over its
    sub-kernel (one conv call per class instead of 1-4 einsums)."""
    gp = F.pad(g, (0, 0, 0, 1, 0, 1))
    # taps ordered by g offset ascending (conv slides ascending):
    # (g row offset, dy)
    row_e = [(0, 1)]
    row_o = [(0, 2), (1, 0)]       # offsets a+0 (dy=2), a+1 (dy=0)
    col_e = [(0, 1)]
    col_o = [(0, 2), (1, 0)]

    def make(rows, cols):
        # OIHW sub-kernel: O = x's channels (cin), I = g's (cout), so
        # each tap is w[dy, dx] [cin, cout] as it is
        k = torch.stack([torch.stack([w[dy, dx] for (_, dx) in cols],
                                     dim=-1) for (_, dy) in rows], dim=-2)
        k = k.to(g.dtype).contiguous(memory_format=torch.channels_last)
        kh, kw = len(rows), len(cols)
        ga = gp[:, :g.shape[1] + kh - 1, :g.shape[2] + kw - 1]
        return F.conv2d(ga.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)

    ee = make(row_e, col_e)
    eo = make(row_e, col_o)
    oe = make(row_o, col_e)
    oo = make(row_o, col_o)
    return _interleave(ee, eo, oe, oo, xshape[1], xshape[2])


def timed(fn, *args):
    """Seconds of one ``fn(*args)`` (``time_calls``: warm-up, then
    ``ITERS`` calls between CUDA events; the last result must sum
    finite)."""
    return time_calls(lambda: fn(*args), ITERS, args[0].device)[0]


def chain_timed(fn, g, w, xshape):
    """``timed(fn, g, w, xshape)``. (The repository tool chains the calls
    through g to serialize them on the TPU; a CUDA stream runs them in
    order.)"""
    return timed(fn, g, w, xshape)


CASES = [
    # (name, H_in, cin, cout) for the 5 darknet s2 convs
    ("s2 608^2  32-> 64", 608, 32, 64),
    ("s2 304^2  64->128", 304, 64, 128),
    ("s2 152^2 128->256", 152, 128, 256),
    ("s2  76^2 256->512", 76, 256, 512),
    ("s2  38^2 512->1024", 38, 512, 1024),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    b, dev = args.batch, resolve_device(args.device)
    print(f"batch={b} dev={dev}", flush=True)
    rng = np.random.default_rng(0)
    rows, host_bound = [], []
    for name, h, cin, cout in CASES:
        w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout))
                              * 0.05).astype(np.float32)).to(dev)
        xshape = (b, h, h, cin)
        g = torch.from_numpy(rng.standard_normal(
            (b, h // 2, h // 2, cout)).astype(np.float32)).to(dev).to(DT)
        # correctness in float32 (TF32 off), against the library's adjoint
        g32 = g.float()
        with no_tf32(), torch.no_grad():
            want = s2dx_xla(g32, w, xshape)
            den = want.abs().max() + 1e-9
            err = float((s2dx_poly(g32, w, xshape) - want).abs().max() / den)
            err2 = float((s2dx_poly_conv(g32, w, xshape) - want).abs().max()
                         / den)
        del g32, want
        wb = w.to(DT)
        with torch.no_grad():
            t_xla = chain_timed(s2dx_xla, g, wb, xshape)
            t_poly = chain_timed(s2dx_poly, g, wb, xshape)
            t_pc = chain_timed(s2dx_poly_conv, g, wb, xshape)
        print(f"{name}: xla {t_xla*1e3:6.2f} ms | poly-einsum "
              f"{t_poly*1e3:6.2f} ms | poly-conv {t_pc*1e3:6.2f} ms "
              f"(relerr {err:.1e}/{err2:.1e})", flush=True)
        rows.append({"name": name, "h": h, "cin": cin, "cout": cout,
                     "xla_ms": t_xla * 1e3, "poly_ms": t_poly * 1e3,
                     "poly_conv_ms": t_pc * 1e3, "relerr_poly": err,
                     "relerr_poly_conv": err2})
        host_bound += [f"{name} {col}" for col, t in (
            ("xla", t_xla), ("poly", t_poly), ("poly_conv", t_pc))
            if t * 1e3 < HOST_BOUND_MS]
        del w, g, wb
    return {"batch": b, "dtype": "bfloat16", "device": str(dev),
            "iters": ITERS, "rows": rows, "host_bound": host_bound}


if __name__ == "__main__":
    main()
