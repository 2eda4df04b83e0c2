"""Patched-image evaluation (reference test_patch_DOTA.py /
test_patch_DOTA_metrics.py detection loop; the repository's
``cli/test_patch.py`` on the port).

    python -m <package>.cli.test_patch --patch final_patch.png \
        --img-dir gt/images --lab-dir gt/yolo-labels_w_conf \
        --out-dir attacked/ --weightfile yolov3-dota.weights [--device cuda]

Pastes a trained patch onto every test image using the eval-mode
transformer (interference-avoiding placement, +-90 deg rotation, no
photometric jitter), detects at --conf, and writes:

- ``images/``              annotated patched images (optional)
- ``yolo-labels_w_conf/``  7-col labels for ALL detections at --conf
- ``yolo-labels/``         7-col labels filtered to obj > --strong-conf

matching the dual-label-dir protocol of
test_patch_DOTA_metrics.py:180-186. The placement draws come from a
``np.random.Generator`` seeded by --seed, as in the JAX package's CLI;
the patch, its warps, the composite and the detector run on --device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from .. import attack
from ..data.assets import load_class_names
from ..data.labels import read_label_file, write_label_file
from ..evals import draw_detections
from ..utils.checkpoint import load_patch_png
from .common import add_model_args, build_detector, list_images, load_scaled


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_model_args(ap)
    ap.add_argument("--patch", required=True, help="trained patch PNG")
    ap.add_argument("--patch-size", type=int, default=224)
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--lab-dir", required=True,
                    help="7-col w_conf labels used for placement")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--conf", type=float, default=0.01)
    ap.add_argument("--strong-conf", type=float, default=0.4)
    ap.add_argument("--nms", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-images", action="store_true")
    args = ap.parse_args(argv)

    det = build_detector(args)
    names = load_class_names()
    patch = torch.from_numpy(load_patch_png(args.patch, args.patch_size)).to(
        det.device)
    cfg = attack.EvalEOTConfig(img_size=args.img_size)
    rng = np.random.default_rng(args.seed)

    lab_all = os.path.join(args.out_dir, "yolo-labels_w_conf")
    lab_strong = os.path.join(args.out_dir, "yolo-labels")
    os.makedirs(lab_all, exist_ok=True)
    os.makedirs(lab_strong, exist_ok=True)
    img_out = os.path.join(args.out_dir, "images")
    if args.save_images:
        os.makedirs(img_out, exist_ok=True)

    files = list_images(args.img_dir)
    for name in files:
        stem = os.path.splitext(name)[0]
        arr = load_scaled(os.path.join(args.img_dir, name), args.img_size)
        labels = read_label_file(
            os.path.join(args.lab_dir, stem + ".txt"), ncols=7)
        if len(labels) == 0:
            labels = np.ones((1, 7), np.float32)
        adv, _ = attack.transform_patch_eval(patch, labels, rng, cfg)
        patched = attack.paste_patch(
            torch.from_numpy(arr).to(det.device)[None], adv[None])
        dets = det.detect_batch(patched, args.conf, args.nms)[0]
        write_label_file(os.path.join(lab_all, stem + ".txt"), dets)
        write_label_file(os.path.join(lab_strong, stem + ".txt"),
                         dets[dets[:, 4] > args.strong_conf])
        if args.save_images:
            vis = Image.fromarray(
                (patched[0].cpu().numpy() * 255).astype(np.uint8))
            draw_detections(vis, dets[dets[:, 4] > args.strong_conf],
                            names, os.path.join(img_out, stem + ".png"))
    print(f"processed {len(files)} images -> {args.out_dir}")


if __name__ == "__main__":
    main()
