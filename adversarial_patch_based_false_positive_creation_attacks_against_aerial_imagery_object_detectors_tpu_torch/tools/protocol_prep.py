"""Build the protocol-scale trainset for ``tools.protocol_run`` (the
repository's ``tools/protocol_prep.py``).

Stage 1-2 of the reference protocol at its own scale: synthesize raw
scenes from the victim's training distribution (reference analog: the
raw DOTA tile pool), then ``cli.images_filter`` them into the
victim-pseudo-labeled train set + held-out clean ground truth (reference
images_filter.py:40-133: "ground truth = victim pseudo-labels"). Split
out of ``tools.attack_quality`` because filtering thousands of tiles is a
long one-time step worth caching between protocol runs;
``tools.protocol_run`` consumes the output directories.

``images_filter`` runs in this process (``attack_quality._run_cli``), its
output appended to ``<out>/prep.log``; ``--device`` (default cuda;
raises where there is no card) goes to it.

    python -m <package>.tools.protocol_prep --out DIR \
        [--raw-train 2600] [--test-scenes 64] [--seed 0] [--mini]
"""

from __future__ import annotations

import argparse
import os
import sys

from ..cli import images_filter
from ..ops._cuda import resolve_device
from .attack_quality import FIXROOT, _run_cli
from .scenes import _gen_scenes

RECORD_IMAGES = 2410   # the reference's filtered trainset of record


def prepare(out, cfg, weights, img_size, raw_train, test_scenes, seed,
            device):
    """Scenes and ``images_filter`` into ``out/{raw_train,raw_test,
    train_set,gt}``; returns (kept train images, kept held-out images)."""
    os.makedirs(out, exist_ok=True)
    log = os.path.join(out, "prep.log")
    # distinct RNG streams: train/test disjoint, and both disjoint from
    # the fixture goldens and from attack_quality's 2024/4048 defaults
    # (a protocol run must not share scenes with the quality-check runs)
    print(f"[1/2] synthesizing {raw_train} train + {test_scenes} test "
          f"scenes @ {img_size}^2", flush=True)
    _gen_scenes(os.path.join(out, "raw_train"), raw_train, 90210 + seed,
                img_size)
    _gen_scenes(os.path.join(out, "raw_test"), test_scenes, 31337 + seed,
                img_size)

    model_args = ["--cfgfile", cfg, "--weightfile", weights,
                  "--img-size", img_size, "--device", device]
    print("[2/2] images_filter (victim pseudo-labels)", flush=True)
    _run_cli(images_filter.main, model_args + [
        "--img-dir", os.path.join(out, "raw_train"),
        "--out-dir", os.path.join(out, "train_set")], log)
    _run_cli(images_filter.main, model_args + [
        "--img-dir", os.path.join(out, "raw_test"),
        "--out-dir", os.path.join(out, "gt")], log)
    return (len(os.listdir(os.path.join(out, "train_set", "images"))),
            len(os.listdir(os.path.join(out, "gt", "images"))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--raw-train", type=int, default=2600,
                    help="raw scenes synthesized; images_filter keeps "
                         "those with >=1 conf-0.01 detection (need "
                         ">=2,410 survivors, the count of record)")
    ap.add_argument("--test-scenes", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--img-size", type=int, default=None)
    ap.add_argument("--mini", action="store_true",
                    help="use the committed mini victim @320^2: a "
                         "fast dress rehearsal of the orchestration, "
                         "not the protocol of record")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.mini:
        fix = os.path.join(FIXROOT, "refparity")
        cfg = os.path.join(fix, "mini_yolov3_dota.cfg")
        weights = os.path.join(fix, "mini_yolov3_dota.weights")
        args.img_size = args.img_size or 320
    else:
        fix = os.path.join(FIXROOT, "refparity_full")
        cfg = os.path.join(fix, "yolov3_dota_synth.cfg")
        weights = os.path.join(fix, "yolov3_dota_synth.weights")
        args.img_size = args.img_size or 608
    if not os.path.exists(weights):
        sys.exit(f"{weights} missing — regenerate with make refparity-full")

    kept, kept_gt = prepare(args.out, cfg, weights, args.img_size,
                            args.raw_train, args.test_scenes, args.seed,
                            args.device)
    print(f"filtered trainset: {kept}/{args.raw_train} kept "
          f"(need >=2,410); held-out gt: {kept_gt}/{args.test_scenes}")
    if kept < RECORD_IMAGES and not args.mini:
        print("WARNING: below the 2,410 count of record — raise "
              "--raw-train and rerun", flush=True)
    return {"out": args.out, "img_size": args.img_size,
            "raw_train": args.raw_train, "kept": kept,
            "test_scenes": args.test_scenes, "kept_gt": kept_gt}


if __name__ == "__main__":
    main()
