"""Creation-attack metrics (reference test_patch_DOTA_metrics.py:301-377;
the repository's ``cli/test_patch_metrics.py`` on the port).

    python -m <package>.cli.test_patch_metrics --pred-dir attacked/ \
        --gt-dir gt/ [--json]

Given the attacked-run label dirs (from ``cli.test_patch``) and the clean
ground-truth label dirs (from ``cli.images_filter``), prints M1 (average
instances created, at 0.4 and 0.01), M2 (average confidence created),
M4 (per-class instance gap), precision/recall and mAP. Host numpy only.
"""

from __future__ import annotations

import argparse
import json
import math
import os

from .. import evals
from ..data.assets import load_class_names


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pred-dir", required=True,
                    help="attacked-run output dir (contains yolo-labels "
                         "and yolo-labels_w_conf)")
    ap.add_argument("--gt-dir", required=True,
                    help="clean ground-truth dir (same two subdirs)")
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--conf", type=float, default=0.4)
    ap.add_argument("--json", action="store_true",
                    help="emit a single JSON object")
    args = ap.parse_args(argv)

    pred_04 = os.path.join(args.pred_dir, "yolo-labels")
    pred_001 = os.path.join(args.pred_dir, "yolo-labels_w_conf")
    gt_04 = os.path.join(args.gt_dir, "yolo-labels")
    gt_001 = os.path.join(args.gt_dir, "yolo-labels_w_conf")
    n_images = len([n for n in os.listdir(gt_04) if n.endswith(".txt")])

    names = load_class_names()
    report = evals.creation_metrics_report(
        pred_04, gt_04, pred_001, gt_001, n_images, len(names))
    precision, recall = evals.precision_recall(pred_001, gt_04, args.conf,
                                               args.iou)
    report["precision"] = precision
    report["recall"] = recall
    report["mAP"] = evals.mean_average_precision(pred_001, gt_04,
                                                 len(names), args.iou)
    if args.json:
        # NaN/Infinity are not valid JSON; emit null instead
        clean = {k: (None if isinstance(v, float) and not math.isfinite(v)
                     else v)
                 for k, v in report.items()}
        print(json.dumps(clean))
        return report

    print(f"images: {n_images}")
    print(f"M1 avg instances created @0.4 : "
          f"{report['M1_avg_instances_created_04']:.4f}")
    print(f"M1 avg instances created @0.01: "
          f"{report['M1_avg_instances_created_001']:.4f}")
    print(f"M2 avg confidence created @0.01: "
          f"{report['M2_avg_conf_created_001']:.4f}")
    print("M4 per-class instance gap @0.01:")
    for name, gap in zip(names, report["M4_per_class_gap_001"]):
        if gap:
            print(f"  {name:20s} {gap:+d}")
    print(f"precision {precision:.4f}  recall {recall:.4f}  "
          f"mAP {report['mAP']:.4f}")
    return report


if __name__ == "__main__":
    main()
