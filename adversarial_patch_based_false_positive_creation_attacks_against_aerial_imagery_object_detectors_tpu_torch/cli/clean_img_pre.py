"""Clean-image inference / label generation (reference clean_img_pre.py;
the repository's ``cli/clean_img_pre.py`` on the port).

    python -m <package>.cli.clean_img_pre --img-dir imgs/ --out-dir clean/ \
        --weightfile yolov3-dota.weights --save-images [--device cuda]

For every image in --img-dir: square-pad (gray 127), resize to the model
input, detect at (--conf, --nms), optionally save an annotated copy, and
write a 7-col label file ``x y w h obj cls_conf cls_id``. The reference
uses this as its smoke test: detections on clean images prove
weights/config/env are wired correctly.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
from PIL import Image

from ..data.assets import load_class_names
from ..data.labels import write_label_file
from ..evals import draw_detections
from .common import add_model_args, build_detector, list_images, load_scaled


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_model_args(ap)
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--conf", type=float, default=0.4)
    ap.add_argument("--nms", type=float, default=0.4)
    ap.add_argument("--save-images", action="store_true")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument(
        "--class-filter", type=int, default=None, metavar="CLS_ID",
        help="keep only detections of this class id (the reference's "
        "commented class-filtered GT-generation variant, "
        "clean_img_pre.py:190-196, which kept cls_id==5)")
    ap.add_argument(
        "--min-box-size", type=float, default=0.0, metavar="FRAC",
        help="with --class-filter: drop boxes with normalized w or h "
        "below FRAC (reference used 0.1)")
    args = ap.parse_args(argv)

    det = build_detector(args)
    names = load_class_names()
    lab_dir = os.path.join(args.out_dir, "yolo-labels")
    os.makedirs(lab_dir, exist_ok=True)
    img_out = os.path.join(args.out_dir, "images")
    if args.save_images:
        os.makedirs(img_out, exist_ok=True)

    files = list_images(args.img_dir)
    t0 = time.time()
    n_boxes = 0
    for i in range(0, len(files), args.batch_size):
        chunk = files[i:i + args.batch_size]
        arrs = [load_scaled(os.path.join(args.img_dir, name), args.img_size)
                for name in chunk]
        dets = det.detect_batch(np.stack(arrs), args.conf, args.nms)
        if args.class_filter is not None:
            dets = [d[(d[:, 6] == args.class_filter)
                      & (d[:, 2] >= args.min_box_size)
                      & (d[:, 3] >= args.min_box_size)] for d in dets]
        for name, arr, d in zip(chunk, arrs, dets):
            stem = os.path.splitext(name)[0]
            write_label_file(os.path.join(lab_dir, stem + ".txt"), d)
            n_boxes += len(d)
            if args.save_images:
                vis = Image.fromarray((arr * 255).astype(np.uint8))
                draw_detections(vis, d, names,
                                os.path.join(img_out, stem + ".png"))
    dt = time.time() - t0
    print(f"{len(files)} images, {n_boxes} detections, {dt:.1f}s "
          f"({len(files) / max(dt, 1e-9):.1f} img/s)")


if __name__ == "__main__":
    main()
