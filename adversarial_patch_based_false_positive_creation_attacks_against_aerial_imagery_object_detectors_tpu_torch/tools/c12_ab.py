"""Numerics and step-time A/B of the conv12-widened fused front (the c12
route: the fused stem, K6a with its masks and conv12 forward; K6c, then
K2 backward) against the default route (the fused stem, layers 6-11 on
the conv walk), the repository's ``tools/c12_ab.py``. One mode per
invocation; a trailing ``c12`` asks for the c12 route:

    python -m <package>.tools.c12_ab grad [c12]    # loss + grad digest, b2 608^2
    python -m <package>.tools.c12_ab step B [c12]  # train-step ms at batch B

The route is an argument (``Darknet(..)(x, fused_stem=True,
res152="c12")``, ``make_train_step(.., res152="c12")``), not the
repository tool's environment variable. ``check_route`` refuses to
report a number under a label whose route a gate silently left: c12 must
report ``{"stem": "c12", "res152": "c12"}`` and the default ``{"stem":
"fused", "res152": "conv"}`` (``models.last_routes()``). ``grad``: the
full-width YOLOv3 with random weights from seed 1, BN-folded, in
bfloat16, on x [2, 608, 608, 3] from ``np.random.default_rng(0)``; the
loss is the heads' sum of squares, the digest its input gradient's sum,
max |g| and L2 norm. ``step``: ``step_profile.build_step``'s default
training step (``paper_obj`` shapes, patch 224, bfloat16; the same
victim) on the route, 3 warm-up steps, then ``STEPS`` timed by CUDA
events (the host's clock on the CPU). The two routes' bfloat16 digests
differ by the summation order of every kernel, not by a fault.
``--device`` defaults to cuda and raises where there is no card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models import (Darknet, build_network, fold_bn, init_params,
                      last_routes, yolov3_blocks)
from ..ops._cuda import resolve_device
from ..utils.profiling import time_calls
from .step_profile import build_step

IMG = 608
STEPS = 30
WANT_ROUTES = {True: {"stem": "c12", "res152": "c12"},
               False: {"stem": "fused", "res152": "conv"}}


def check_route(c12: bool) -> dict:
    """Exit (non-zero) unless the last forward on this thread took the
    route asked for (``WANT_ROUTES``: a dispatch gate that fell back must
    not be reported under the route's label); returns the routes."""
    routes = last_routes()
    if routes != WANT_ROUTES[c12]:
        sys.exit(f"{'c12' if c12 else 'the default route'} requested but "
                 f"the forward took {routes}, not {WANT_ROUTES[c12]} - a "
                 f"gate fell back; this reading must not be reported "
                 f"under that label")
    return routes


def grad_digest(dev, c12: bool) -> dict:
    """The loss and the input-gradient digest of the ``grad`` mode."""
    net = build_network(yolov3_blocks())
    model = Darknet(net, fold_bn(net, init_params(net, 1)), torch.bfloat16,
                    device=dev).eval()
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, IMG, IMG, 3), np.float32)).to(dev).requires_grad_(True)
    heads = model(x, fused_stem=True, res152="c12" if c12 else None)
    routes = check_route(c12)
    val = sum((h.float() ** 2).sum() for h in heads)
    (grad,) = torch.autograd.grad(val, x)
    g = grad.double()
    out = {"loss": float(val.detach()), "gsum": float(g.sum()),
           "gmax": float(g.abs().max()), "gnorm": float(g.norm()),
           "routes": routes}
    print(f"loss={out['loss']:.6e} gsum={out['gsum']:.6e} "
          f"gmax={out['gmax']:.6e} gnorm={out['gnorm']:.6e}")
    return out


def step_time(dev, b: int, c12: bool) -> dict:
    """ms a training step of the ``step`` mode at batch ``b``."""
    run, mesh = build_step(b, dev, res152="c12" if c12 else None)
    for _ in range(3):
        aux = run()
    routes = check_route(c12)
    float(aux["loss"])
    dt, loss = time_calls(lambda: run()["loss"], STEPS, mesh.device,
                          warmup=0)
    loss = float(loss)
    print(f"batch {b}: {dt * 1e3:.2f} ms/step "
          f"({60.0 / dt:.0f} steps/min, loss {loss:.4f})")
    return {"batch": b, "steps": STEPS, "ms_per_step": dt * 1e3,
            "steps_per_min": 60.0 / dt, "loss": loss, "routes": routes}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        usage="%(prog)s {grad [c12] | step B [c12]} [--device DEVICE]")
    ap.add_argument("mode", choices=("grad", "step"))
    ap.add_argument("rest", nargs="*", help="grad: [c12]; step: B [c12]")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    c12 = args.rest[-1:] == ["c12"]
    rest = args.rest[:-1] if c12 else args.rest
    if len(rest) != (args.mode == "step") or (rest and not rest[0].isdigit()):
        ap.error(f"{args.mode}: expected "
                 f"{'B [c12]' if args.mode == 'step' else '[c12]'}, got "
                 f"{args.rest}")
    dev = resolve_device(args.device)
    route = "c12" if c12 else "default"
    if args.mode == "grad":
        out = grad_digest(dev, c12)
    else:
        out = step_time(dev, int(rest[0]), c12)
    return {"mode": args.mode, "route": route, "device": str(dev), **out}


if __name__ == "__main__":
    main()
