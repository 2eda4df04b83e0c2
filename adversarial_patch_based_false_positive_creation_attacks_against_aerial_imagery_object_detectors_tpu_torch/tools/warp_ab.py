"""A/B: does the matmul-factored (sheared tensor-product) warp's rotation
approximation cost attack quality against the exact gather warp? (The
repository's ``tools/warp_ab.py``.)

Trains two patches with identical seeds and data on the crafted
brightness victim (``tools/victims.py``) with rotation on (U(-pi, pi),
the attack-of-record regime where the ``mxu`` warp is approximate), then
evaluates the creation metrics M1 / M2 at conf 0.4 and 0.01 over
held-out scenes, pasting each patch through both warps (4 rows): what
matters is the quality of the *trained patch*, not the warp's pixel
residual. The table is the quality gate of any change to the warp.

The patch init and the training's EOT draws come from a
``torch.Generator`` seeded 0 for each patch; the paste's draws are made
once, from a generator seeded 5, and shared by every row. The victim
runs in float32 (TF32 off) on ``--device`` (default cuda; raises where
there is no card). Times are not measured here.

    python -m <package>.tools.warp_ab [steps] [n_eval]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import train as T
from ..attack.eot import EOTConfig, apply_eot_patch, draw_eot
from ..evals import (Detector, m1_average_instances_created,
                     m2_average_confidence_created)
from ..ops._cuda import no_tf32, resolve_device
from .victims import IMG, craft_brightness_victim

PATCH = 16
MAX_LABELS = 8
LABEL_ROW = (0, 0.5, 0.9, 0.9, 0.9)
COLUMNS = ("M1@0.4", "M2@0.4", "M1@0.01", "M2@0.01")


def scenes(seed: int, n: int):
    """``n`` dark scenes (U[0, 0.4) from ``default_rng(seed)``) and their
    labels (one 0.9-wide box, repeated), as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    imgs = (rng.random((n, IMG, IMG, 3)) * 0.4).astype(np.float32)
    labs = np.tile(np.array([LABEL_ROW], np.float32), (n, MAX_LABELS, 1))
    return imgs, labs


def train_with(model, imgs, labs, steps: int, **overrides):
    """``steps`` float32 steps of the A/B's experiment (``untargeted_obj``,
    lr 0.3, rotation on, no cell swap, patch 16) with ``overrides``;
    returns (patch, final loss)."""
    b = imgs.shape[0]
    exp = T.ExperimentConfig(
        name="ab", img_size=IMG, patch_size=PATCH, batch_size=b,
        max_labels=MAX_LABELS, compute_dtype="float32",
        loss_recipe="untargeted_obj", learning_rate=0.3, do_rotate=True,
        cell_swap_xy=False, **overrides)
    step = T.make_train_step(model, exp)
    generator = torch.Generator(device=imgs.device)
    generator.manual_seed(0)
    patch = T.init_patch(exp, generator).requires_grad_(True)
    optimizer = T.make_optimizer(patch, exp.learning_rate)
    cfg = T.eot_config(exp)
    aux = None
    with no_tf32():
        for _ in range(steps):
            aux = step(patch, optimizer, imgs, labs, exp.learning_rate,
                       draw_eot(generator, b, PATCH, cfg))
    loss = float(aux["loss"]) if aux is not None else float("nan")
    return patch.detach(), loss


def train_patch(model, warp_method, imgs, labs, steps):
    return train_with(model, imgs, labs, steps, warp_method=warp_method)


def paste_draws(n: int, device):
    """The paste's EOT draws, made once and shared by every row."""
    generator = torch.Generator(device=device)
    generator.manual_seed(5)
    return draw_eot(generator, n, PATCH, EOTConfig(img_size=IMG))


@torch.no_grad()
def paste(patch, imgs, labs, draws, warp_method: str = "mxu"):
    """The held-out scenes with ``patch`` pasted by the float32 EOT
    through ``warp_method``."""
    eot = EOTConfig(img_size=IMG, do_rotate=True, warp_method=warp_method)
    with no_tf32():
        patched, _ = apply_eot_patch(patch, imgs, labs, draws, eot)
    return patched


def creation_row(det, patched, clean) -> dict:
    """M1 / M2 at conf 0.4 and 0.01 of the patched scenes against the
    clean scenes' detections ``clean`` (conf -> detections)."""
    n = patched.shape[0]
    row = {}
    for conf in (0.4, 0.01):
        pre = det.detect_batch(patched, conf, 0.4)
        row[f"M1@{conf}"] = m1_average_instances_created(pre, clean[conf],
                                                         n_images=n)
        row[f"M2@{conf}"] = m2_average_confidence_created(pre, clean[conf])
    return row


def setup(n_eval: int, dev):
    """The victim's detector (float32, 256 candidates), the training and
    held-out scenes on ``dev``, and the clean detections at 0.4 / 0.01."""
    net, params = craft_brightness_victim()
    det = Detector(net, params, img_size=IMG, compute_dtype=torch.float32,
                   max_candidates=256, device=dev)
    imgs, labs = (torch.from_numpy(a).to(dev) for a in scenes(1, 8))
    eval_imgs, eval_labs = (torch.from_numpy(a).to(dev)
                            for a in scenes(42, n_eval))
    clean = {conf: det.detect_batch(eval_imgs, conf, 0.4)
             for conf in (0.4, 0.01)}
    print(f"clean dets @0.4: {sum(len(d) for d in clean[0.4])}, "
          f"@0.01: {sum(len(d) for d in clean[0.01])}", flush=True)
    return det, (imgs, labs), (eval_imgs, eval_labs), clean


def format_row(row: dict) -> str:
    return "  ".join(f"{row[c]:6.3f}" if row[c] == row[c] else "   nan"
                     for c in COLUMNS)


def parse(argv, doc):
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=600)
    ap.add_argument("n_eval", nargs="?", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv, __doc__)
    dev = resolve_device(args.device)
    det, (imgs, labs), (eval_imgs, eval_labs), clean = setup(args.n_eval,
                                                             dev)
    patches, losses = {}, {}
    for wm in ("mxu", "gather"):
        patches[wm], losses[wm] = train_patch(det.model, wm, imgs, labs,
                                              args.steps)
        print(f"trained[{wm}]: final loss {losses[wm]:.4f} "
              f"mean {float(patches[wm].mean()):.3f}", flush=True)

    draws = paste_draws(args.n_eval, dev)
    table = []
    print("\ntrain-warp  paste-warp  M1@0.4  M2@0.4  M1@0.01  M2@0.01")
    for wm, patch in patches.items():
        for pw in ("mxu", "gather"):
            row = creation_row(det, paste(patch, eval_imgs, eval_labs,
                                          draws, pw), clean)
            table.append({"train_warp": wm, "paste_warp": pw, **row})
            print(f"{wm:10s}  {pw:10s}  " + format_row(row), flush=True)
    return {"steps": args.steps, "n_eval": args.n_eval,
            "clean": {str(c): sum(len(d) for d in v)
                      for c, v in clean.items()},
            "final_loss": losses, "table": table}


if __name__ == "__main__":
    main()
