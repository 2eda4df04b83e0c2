"""A/B of the YOLOv3 stem (layers 0-5) three ways (the repository's
``tools/stem_fused_ab.py``): the stem as cuDNN convs (``xla_stem``,
autograd for its backward), the planar stem (K3a -> K4 x 5 -> K3b) and
the fused stem, forward and forward + backward.

The fused forward is ``split_phases`` (K3a) -> ``fused_stem_fwd`` (K1)
-> ``from_planar`` (K3b); forward + backward either recomputes the masks
(``fused_stem_remat``: K1, then the tiled K3a and K5) or saves them
(``fused_stem``: K1 ``save_acts``, then the tiled K3a and K2). A batch-1
bfloat16 sanity line comes first: the fused stem's relative error
against the cuDNN walk. Weights and inputs are the repository tool's
(``np.random.default_rng(0)``). Each series is ``ITERS`` back-to-back
calls after a warm-up between CUDA events (the host's clock on the CPU).
The repository tool's third argument ``s5`` (the Pallas kernel's conv5
stripe height) is refused: TPU blocking, a pinned deviation. ``--device``
defaults to cuda and raises where there is no card.

    python -m <package>.tools.stem_fused_ab [batch] [h]
"""

from __future__ import annotations

import argparse

import torch

from ..models.stem_planar import planar_stem, planar_stem_params
from ..ops import stem_fused as SF
from ..ops._cuda import resolve_device
from ..ops.planar_conv import from_planar
from ..utils.profiling import HOST_BOUND_MS, time_calls
from .stem_ab import input_grad, stem_inputs
from .stem_ab import xla_stem as _cudnn_stem

ITERS = 20


def timed(fn, x, iters=ITERS):
    """Seconds of one ``fn(x)`` (``time_calls``: warm-up, then ``iters``
    calls between CUDA events; the last result must sum finite)."""
    return time_calls(lambda: fn(x), iters, x.device)[0]


def xla_stem(v, sp):
    """``stem_ab.xla_stem``: layers 0-5 as cuDNN convs, NHWC y5."""
    return _cudnn_stem(v, sp)


def loss_xla(v, sp):
    return xla_stem(v, sp).float().sum()


def loss_planar(v, fwd, bwd):
    return planar_stem(v, fwd, bwd).float().sum()


def fused(v, sp):
    """The fused forward: ``split_phases`` -> K1 -> ``from_planar``."""
    xe, xo = SF.split_phases(v)
    return from_planar(SF.fused_stem_fwd(xe, xo, sp), v.shape[1] // 4, 128)


def loss_fused(v, sp, sbp):
    return SF.fused_stem(v, sp, sbp).float().sum()


def loss_fused_remat(v, sp, sbp):
    return SF.fused_stem_remat(v, sp, sbp).float().sum()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("h", nargs="?", type=int, default=608)
    ap.add_argument("s5", nargs="?", type=int,
                    help="refused: the Pallas kernel's conv5 stripe height "
                         "has no counterpart in the port")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    if args.s5 is not None:
        ap.error(f"s5={args.s5}: the conv5 stripe height is TPU blocking "
                 "of the Pallas kernel, a pinned deviation; the port's K1 "
                 "takes no s5")
    b, h, dev = args.batch, args.h, resolve_device(args.device)
    sp, x0, _ = stem_inputs(b, h, dev)
    fwd, bwd = planar_stem_params(sp)
    sbp = SF.stem_bwd_params(sp)
    print(f"batch={b} H={h} dev={dev}", flush=True)
    # numerical sanity on the device before timing
    with torch.no_grad():
        ref = xla_stem(x0[:1], sp).float()
        got = SF.fused_stem(x0[:1], sp).float()
        err = float((got - ref).abs().max()
                    / max(float(ref.abs().max()), 1e-6))
    print(f"fused fwd rel-err vs cuDNN (bf16): {err:.3e}", flush=True)
    rows = {}

    def row(label, fn):
        rows[label] = timed(fn, x0) * 1e3
        print(f"{label:22s}: {rows[label]:7.2f} ms", flush=True)

    with torch.no_grad():
        row("cuDNN  fwd", lambda v: xla_stem(v, sp))
        row("planar fwd", lambda v: planar_stem(v, fwd))
        row("fused  fwd", lambda v: fused(v, sp))
    row("cuDNN  fwd+bwd", lambda v: input_grad(loss_xla, v, sp))
    row("fused  fwd+bwd (remat)",
        lambda v: input_grad(loss_fused_remat, v, sp, sbp))
    row("fused  fwd+bwd (saved)",
        lambda v: input_grad(loss_fused, v, sp, sbp))
    return {"batch": b, "h": h, "dtype": "bfloat16", "device": str(dev),
            "iters": ITERS, "fused_fwd_rel_err_b1": err, "ms": rows,
            "host_bound": [k for k, t in rows.items() if t < HOST_BOUND_MS]}


if __name__ == "__main__":
    main()
