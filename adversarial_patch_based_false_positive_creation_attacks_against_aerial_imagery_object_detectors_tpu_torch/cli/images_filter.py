"""Attack train/test-set construction (reference images_filter.py; the
repository's ``cli/images_filter.py`` on the port).

    python -m <package>.cli.images_filter --img-dir raw/ --out-dir gt/ \
        --weightfile yolov3-dota.weights [--device cuda]

Runs the victim over raw DOTA 608-tiles at conf 0.01; keeps images with
at least one detection; writes the image plus two label dirs:
5-col pseudo-GT (``cls x y w h``) for detections with obj > --gt-conf,
and 7-col w_conf labels for all detections, i.e. ground truth is the
victim's own pseudo-labels, at two thresholds, matching the reference's
data protocol (images_filter.py:99-124).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from ..data.labels import write_label_file
from ..evals import detections_to_label_rows
from .common import add_model_args, build_detector, list_images, load_scaled


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    add_model_args(ap)
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--conf", type=float, default=0.01)
    ap.add_argument("--gt-conf", type=float, default=0.4)
    ap.add_argument("--nms", type=float, default=0.4)
    ap.add_argument("--batch-size", type=int, default=8)
    args = ap.parse_args(argv)

    det = build_detector(args)
    img_out = os.path.join(args.out_dir, "images")
    lab_out = os.path.join(args.out_dir, "yolo-labels")
    lab_conf_out = os.path.join(args.out_dir, "yolo-labels_w_conf")
    for d in (img_out, lab_out, lab_conf_out):
        os.makedirs(d, exist_ok=True)

    files = list_images(args.img_dir)
    kept = 0
    for i in range(0, len(files), args.batch_size):
        chunk = files[i:i + args.batch_size]
        arrs = [load_scaled(os.path.join(args.img_dir, name), args.img_size)
                for name in chunk]
        dets = det.detect_batch(np.stack(arrs), args.conf, args.nms)
        for name, arr, d in zip(chunk, arrs, dets):
            if len(d) == 0:
                continue
            kept += 1
            stem = os.path.splitext(name)[0]
            Image.fromarray((arr * 255).astype(np.uint8)).save(
                os.path.join(img_out, stem + ".png"))
            strong = d[d[:, 4] > args.gt_conf]
            write_label_file(os.path.join(lab_out, stem + ".txt"),
                             detections_to_label_rows(strong, False))
            write_label_file(os.path.join(lab_conf_out, stem + ".txt"), d)
    print(f"kept {kept}/{len(files)} images with >=1 detection")


if __name__ == "__main__":
    main()
