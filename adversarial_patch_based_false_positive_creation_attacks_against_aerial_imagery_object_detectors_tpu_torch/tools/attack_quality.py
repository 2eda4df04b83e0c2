"""End-to-end attack-quality evaluation through the port's CLIs (the
repository's ``tools/attack_quality.py``).

The reference's acceptance criterion is the full creation-metric
protocol (test_patch_DOTA_metrics.py:301-377): train a patch, paste it
with interference-avoiding placement on held-out scenes, and report
M1/M2/M4/mAP against the same scenes' clean pseudo-labels. This tool
runs that protocol end to end through the port's CLIs against a
refparity victim (``tests/fixtures/refparity*``):

  1. synthesize train + held-out test scenes from the victim's training
     distribution (``tools.scenes``; distinct RNG streams, both distinct
     from the fixture's golden tiles),
  2. ``cli.images_filter``  -> victim-pseudo-labeled train set and clean
     test-set ground truth (the images_filter protocol),
  3. ``cli.train_patch``    -> paper_obj patch (b24, lr 0.03, TV 2.5,
     NPS 0.01, target 14: the hyperparameters of record),
  4. ``cli.test_patch``     -> paste on held-out scenes (eval-mode
     transformer: occupancy-map placement, +-90 deg) + detect at 0.01,
     for the trained patch and a random-patch control (same placement
     machinery, same seed, same ground truth: separates optimization
     from occlusion),
  5. ``cli.test_patch_metrics --json`` -> M1@0.4, M1@0.01, M2, M4, mAP.

Scales: ``--mini`` (committed 14-block victim, 320^2, patch 112) or
``--full`` (the 75-conv yolov3-dota graph, 608^2, patch 224; needs
``tests/fixtures/refparity_full``, which is not committed).

Unlike the repository's tool, which runs each CLI as a subprocess, this
one calls each CLI module's ``main(argv)`` in its own process and appends
what it prints to ``<out>/cli.log``: the built kernels and the CUDA
context are reused, a caller can count the kernels' launches, and the
device's cached memory is released after each CLI. ``--device`` (default
cuda; raises where there is no card) goes to every CLI that takes one.

Values above 1 in the printed precision column are reference parity:
``eval_list`` counts ``correct`` over all prediction rows but
``proposals`` only above the conf threshold (reference
utils_self.py:44-60).

    python -m <package>.tools.attack_quality --mini [--epochs 150] [--out DIR]
    python -m <package>.tools.attack_quality --full
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
from PIL import Image

from ..cli import images_filter, test_patch, test_patch_metrics, train_patch
from ..ops._cuda import resolve_device
from .scenes import _gen_scenes

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXROOT = os.path.join(REPO, "tests", "fixtures")


def _release() -> None:
    """Free what a finished CLI left: its trainer, store and detector are
    garbage once its ``main`` returns; the card's cached blocks go back."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _run_cli(main, argv, log) -> str:
    """Run a port CLI's ``main(argv)`` in this process; append what it
    prints (stdout, then stderr) to ``log`` and return its stdout."""
    argv = [str(a) for a in argv]
    name = main.__module__.rsplit(".", 1)[-1]
    print(f"  $ {name} {' '.join(argv[:6])} ...", flush=True)
    out, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(argv)
    finally:
        with open(log, "a") as f:
            f.write(f"\n=== {name} {' '.join(argv)}\n{out.getvalue()}\n"
                    f"{err.getvalue()}\n")
        _release()
    print(f"    done in {time.time() - t0:.0f}s", flush=True)
    return out.getvalue()


def write_control_patch(path, patch_size, seed=123):
    """The random-patch control: same pixel distribution as the
    trainer's init (U[0,1]), untouched by optimization; the repository
    tool's pixels for the same seed."""
    rng = np.random.default_rng(seed)
    Image.fromarray((rng.random((patch_size, patch_size, 3)) * 255)
                    .astype(np.uint8)).save(path)


def _extract_json(stdout):
    for line in reversed(stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError("no JSON line in metrics output")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    scale = ap.add_mutually_exclusive_group(required=True)
    scale.add_argument("--mini", action="store_true")
    scale.add_argument("--full", action="store_true")
    ap.add_argument("--train-scenes", type=int, default=96)
    ap.add_argument("--test-scenes", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=150,
                    help="patch-training epochs (4 b24 batches each at "
                         "96 train scenes -> 600 steps at 150)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--force", action="store_true",
                    help="wipe a non-empty --out dir instead of "
                         "refusing to reuse it")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    if args.full:
        fix, victim = os.path.join(FIXROOT, "refparity_full"), \
            "yolov3_dota_synth"
        img, patch = 608, 224
        tag = "full"
    else:
        fix, victim = os.path.join(FIXROOT, "refparity"), \
            "mini_yolov3_dota"
        img, patch = 320, 112
        tag = "mini"
    cfg = os.path.join(fix, f"{victim}.cfg")
    weights = os.path.join(fix, f"{victim}.weights")
    if not os.path.exists(weights):
        sys.exit(f"{weights} missing — regenerate with "
                 f"make refparity-full" if args.full else
                 f"{weights} missing")

    out = args.out or os.path.join(tempfile.gettempdir(),
                                   f"attack_quality_{tag}")
    if os.path.isdir(out) and os.listdir(out):
        # A previous run's scenes/labels would silently mix into the
        # train/gt sets (images_filter sweeps whole directories and
        # scene counts/seeds change filenames) and contaminate the
        # reported metrics: start clean every run.
        if not args.force:
            sys.exit(f"{out} exists and is non-empty; pass --force to "
                     f"wipe it (a stale run mixed in would corrupt the "
                     f"metrics) or choose a fresh --out")
        shutil.rmtree(out)
    os.makedirs(out, exist_ok=True)
    log = os.path.join(out, "cli.log")
    model_args = ["--cfgfile", cfg, "--weightfile", weights,
                  "--img-size", img, "--device", args.device]

    print(f"[1/5] scenes ({args.train_scenes} train + {args.test_scenes} "
          f"test @ {img}^2)", flush=True)
    _gen_scenes(os.path.join(out, "raw_train"), args.train_scenes,
                2024 + args.seed, img)
    _gen_scenes(os.path.join(out, "raw_test"), args.test_scenes,
                4048 + args.seed, img)

    print("[2/5] images_filter (victim pseudo-labels)", flush=True)
    _run_cli(images_filter.main, model_args + [
        "--img-dir", os.path.join(out, "raw_train"),
        "--out-dir", os.path.join(out, "train_set")], log)
    _run_cli(images_filter.main, model_args + [
        "--img-dir", os.path.join(out, "raw_test"),
        "--out-dir", os.path.join(out, "gt")], log)

    print(f"[3/5] train_patch paper_obj ({args.epochs} epochs)",
          flush=True)
    run_dir = os.path.join(out, "run")
    _run_cli(train_patch.main, [
        "--mode", "paper_obj",
        "--cfgfile", cfg, "--weightfile", weights,
        "--img-dir", os.path.join(out, "train_set", "images"),
        "--lab-dir", os.path.join(out, "train_set", "yolo-labels"),
        "--img-size", img, "--patch-size", patch,
        "--epochs", args.epochs, "--seed", args.seed,
        "--out-dir", run_dir, "--device", args.device], log)

    ctrl_png = os.path.join(out, "random_patch.png")
    write_control_patch(ctrl_png, patch)

    print("[4/5] test_patch (paste + detect, trained & random control)",
          flush=True)
    results = {}
    for name, png in (("trained", os.path.join(run_dir,
                                               "final_patch.png")),
                      ("random", ctrl_png)):
        _run_cli(test_patch.main, model_args + [
            "--patch", png, "--patch-size", patch,
            "--img-dir", os.path.join(out, "gt", "images"),
            "--lab-dir", os.path.join(out, "gt", "yolo-labels_w_conf"),
            "--out-dir", os.path.join(out, f"attacked_{name}"),
            "--seed", args.seed], log)

        print(f"[5/5] metrics ({name})", flush=True)
        stdout = _run_cli(test_patch_metrics.main, [
            "--pred-dir", os.path.join(out, f"attacked_{name}"),
            "--gt-dir", os.path.join(out, "gt"), "--json"], log)
        results[name] = _extract_json(stdout)

    cols = ("M1_avg_instances_created_04", "M1_avg_instances_created_001",
            "M2_avg_conf_created_001", "mAP", "precision", "recall")
    hdr = ("patch", "M1@0.4", "M1@0.01", "M2@0.01", "mAP", "prec", "rec")
    print(f"\nattack-quality @ {tag} ({img}^2, patch {patch}, "
          f"paper_obj b24, {args.epochs * max(1, args.train_scenes // 24)}"
          f" steps, {args.test_scenes} held-out scenes):\n")
    print("| " + " | ".join(hdr) + " |")
    print("|" + "---|" * len(hdr))
    for name in ("random", "trained"):
        r = results[name]
        row = [name] + [
            "-" if r.get(c) is None else f"{r[c]:.3f}" for c in cols]
        print("| " + " | ".join(row) + " |")

    summary = {"scale": tag, "img": img, "patch": patch,
               "epochs": args.epochs, "seed": args.seed,
               "train_scenes": args.train_scenes,
               "test_scenes": args.test_scenes, "results": results}
    path = os.path.join(out, "summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\nwrote {path}")
    return summary


if __name__ == "__main__":
    main()
