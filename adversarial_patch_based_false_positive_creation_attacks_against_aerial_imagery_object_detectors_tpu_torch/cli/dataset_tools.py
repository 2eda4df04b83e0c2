"""Dataset tooling (reference Txt_gen.py + img_label_len_calculate.py +
recall_DOTA.py; the repository's ``cli/dataset_tools.py`` on the port).

    python -m <package>.cli.dataset_tools list-files --img-dir imgs/ \
        --out list.txt
    python -m <package>.cli.dataset_tools stats --img-dir imgs/ \
        --lab-dir labels/ [--hist hist.png]
    python -m <package>.cli.dataset_tools recall --pred-dir preds/ \
        --gt-dir labels/

Subcommands:
  list-files   write train/val file lists (Txt_gen parity)
  stats        dataset statistics: image/label counts, instances,
               max labels per image, per-class histogram
  recall       precision/recall of predicted 7-col labels vs 5-col GT

Host only. matplotlib is imported only for ``stats --hist``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import evals
from ..data.assets import load_class_names
from ..data.labels import count_instances
from .common import list_images


def cmd_list_files(args):
    files = list_images(args.img_dir)
    with open(args.out, "w") as f:
        for name in files:
            f.write(os.path.abspath(os.path.join(args.img_dir, name))
                    + "\n")
    print(f"wrote {len(files)} paths to {args.out}")


def cmd_stats(args):
    n_images = len(list_images(args.img_dir))
    total, per_file = count_instances(args.lab_dir)
    print(f"images: {n_images}")
    print(f"label files: "
          f"{len([f for f in os.listdir(args.lab_dir) if f.endswith('.txt')])}")
    print(f"instances: {total}")
    if per_file:
        print(f"max labels per image: {max(per_file)}")
        print(f"mean labels per image: {np.mean(per_file):.2f}")
    names = load_class_names()
    counts = evals.instances_per_class(args.lab_dir, len(names),
                                       ncols=args.ncols)
    for name, c in zip(names, counts):
        if c:
            print(f"  {name:20s} {c}")
    if args.hist and per_file:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; skipping histogram")
            return
        plt.bar(range(len(per_file)), sorted(per_file))
        plt.xlabel("image (sorted)")
        plt.ylabel("instances")
        plt.savefig(args.hist)
        print(f"histogram -> {args.hist}")


def cmd_recall(args):
    p, r = evals.precision_recall(args.pred_dir, args.gt_dir,
                                  args.conf, args.iou)
    fscore = 2 * p * r / (p + r + 1e-6)
    print(f"precision {p:.4f}  recall {r:.4f}  fscore {fscore:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p1 = sub.add_parser("list-files")
    p1.add_argument("--img-dir", required=True)
    p1.add_argument("--out", required=True)
    p1.set_defaults(fn=cmd_list_files)

    p2 = sub.add_parser("stats")
    p2.add_argument("--img-dir", required=True)
    p2.add_argument("--lab-dir", required=True)
    p2.add_argument("--ncols", type=int, default=5)
    p2.add_argument("--hist", default=None,
                    help="save an instances-per-image histogram PNG "
                         "(utils_self.hist_draw parity)")
    p2.set_defaults(fn=cmd_stats)

    p3 = sub.add_parser("recall")
    p3.add_argument("--pred-dir", required=True)
    p3.add_argument("--gt-dir", required=True)
    p3.add_argument("--conf", type=float, default=0.4)
    p3.add_argument("--iou", type=float, default=0.5)
    p3.set_defaults(fn=cmd_recall)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
