"""Full-scale stability soak on the port (the repository's
``tools/soak.py``): N patch-optimization steps (``make_train_step``) on
the 608^2 YOLOv3 victim graph (``yolov3_blocks()``, random weights from
seed 1) with the production defaults (bf16 detector + bf16 EOT warp, the
fused stem: K3a ``split_phases``, K1 ``save_acts`` and K3b forward, the
tiled K3a and K2 backward on a card), checking that every loss component
stays finite, the patch stays in [0, 1], and the loss decays. Reads the
losses and the patch at step 0, every 200 steps and the last, and
synchronizes the card before reading the clock.

``--cfgfile`` / ``--img-size`` / ``--patch-size`` take another victim
(a small one for a CPU check); ``--device`` defaults to cuda and raises
where there is no card.

    python -m <package>.tools.soak [steps] [batch]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import train as T
from ..attack.eot import draw_eot
from ..models import (Darknet, build_network, fold_bn, init_params,
                      last_routes, network_from_cfg, yolov3_blocks)
from ..ops._cuda import resolve_device

MAX_LABELS = 252


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=2000)
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--cfgfile", default=None,
                    help="darknet .cfg (default: built-in yolov3-dota)")
    ap.add_argument("--img-size", type=int, default=608)
    ap.add_argument("--patch-size", type=int, default=224)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    steps, batch, size = args.steps, args.batch, args.img_size

    exp = T.ExperimentConfig(name="soak", img_size=size,
                             patch_size=args.patch_size, batch_size=batch,
                             max_labels=MAX_LABELS, compute_dtype="bfloat16")
    net = (network_from_cfg(args.cfgfile) if args.cfgfile else
           build_network(yolov3_blocks(width=size, height=size)))
    model = Darknet(net, fold_bn(net, init_params(net, 1)), torch.bfloat16,
                    device=dev).eval()
    step = T.make_train_step(model, exp)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    patch = T.init_patch(exp, generator).requires_grad_(True)
    optimizer = T.make_optimizer(patch, exp.learning_rate)
    eot = T.eot_config(exp)

    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.random((batch, size, size, 3), np.float32)).to(dev)
    labels = np.full((batch, MAX_LABELS, 5), 1e-6, np.float32)
    labels[:, 0] = [0, 0.5, 0.5, 0.1, 0.15]
    labels = torch.from_numpy(labels).to(dev)
    lr = 0.03

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    first = None
    for i in range(steps):
        aux = step(patch, optimizer, images, labels, lr,
                   draw_eot(generator, batch, exp.patch_size, eot))
        if i % 200 == 0 or i == steps - 1:
            vals = {k: float(v) for k, v in aux.items()}
            if first is None:
                first = vals["loss"]
            assert all(np.isfinite(v) for v in vals.values()), (i, vals)
            p = patch.detach()
            lo, hi = float(p.min()), float(p.max())
            assert lo >= 0.0 and hi <= 1.0, (i, lo, hi)
            print(f"step {i}: loss {vals['loss']:.4f} "
                  f"(no_obj {vals['no_obj']:.3f} no_cls {vals['no_cls']:.3f} "
                  f"tv {vals['tv']:.3f}) patch [{lo:.3f},{hi:.3f}]",
                  flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    last = float(aux["loss"])
    print(f"\nsoak: {steps} steps in {dt:.1f}s "
          f"({steps / dt * 60:.0f} steps/min incl. host syncs); "
          f"loss {first:.3f} -> {last:.3f}; all finite; patch in [0,1]")
    assert last < first, "loss did not decrease over the soak"
    return {"steps": steps, "batch": batch, "img_size": size,
            "seconds": dt, "steps_per_min": steps / dt * 60,
            "loss_first": first, "loss_last": last,
            "routes": dict(last_routes())}


if __name__ == "__main__":
    main()
