"""Paste a trained patch onto images and save the composites (the
repository's ``cli/paste_patch.py`` on the port; the working equivalent
of the reference's broken patch_applier.py script).

    python -m <package>.cli.paste_patch --patch final_patch.png \
        --img-dir imgs/ --lab-dir labels/ --out-dir pasted/ [--device cuda]
    python -m <package>.cli.paste_patch ... --fixed-center 0.5 0.5 \
        --fixed-scale 0.4

Train-mode EOT placement (random center/rotation/scale drawn from
per-image labels; the draws from a ``torch.Generator`` seeded by --seed,
on --device) or a fixed center/scale via flags.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from .. import attack
from ..data.labels import pad_labels, read_label_file
from ..ops._cuda import resolve_device
from ..utils.checkpoint import load_patch_png
from .common import list_images, load_scaled


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--patch", required=True)
    ap.add_argument("--patch-size", type=int, default=224)
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--lab-dir", default=None,
                    help="5-col labels driving EOT scale (omit for fixed)")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--img-size", type=int, default=608)
    ap.add_argument("--fixed-center", type=float, nargs=2, default=None,
                    metavar=("X", "Y"),
                    help="normalized center; disables random placement")
    ap.add_argument("--fixed-scale", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    patch = torch.from_numpy(load_patch_png(args.patch, args.patch_size)).to(
        dev)
    os.makedirs(args.out_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cfg = attack.EOTConfig(img_size=args.img_size)

    def one(v):
        return torch.tensor([v], dtype=torch.float32, device=dev)

    files = list_images(args.img_dir)
    for name in files:
        stem = os.path.splitext(name)[0]
        arr = torch.from_numpy(load_scaled(
            os.path.join(args.img_dir, name), args.img_size)).to(dev)
        if args.fixed_center is not None:
            x, y = args.fixed_center
            adv, _ = attack.warp_patch(
                torch.clamp(patch, 0, 1)[None], one(0.0),
                one(args.fixed_scale), one(x), one(y), args.img_size)
        else:
            labels = np.zeros((0, 5), np.float32)
            if args.lab_dir:
                labels = read_label_file(
                    os.path.join(args.lab_dir, stem + ".txt"), 5)
            labels = pad_labels(labels, max(len(labels), 1))[None]
            draws = attack.draw_eot(gen, 1, args.patch_size, cfg)
            adv, _, _ = attack.transform_patch(
                patch, torch.from_numpy(labels).to(dev), draws, cfg)
        out = attack.paste_patch(arr[None], adv)[0].cpu().numpy()
        Image.fromarray((out * 255).astype(np.uint8)).save(
            os.path.join(args.out_dir, stem + ".png"))
    print(f"pasted onto {len(files)} images -> {args.out_dir}")


if __name__ == "__main__":
    main()
