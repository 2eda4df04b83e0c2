"""The complete reference protocol, at the reference's own scale, on the
port (the repository's ``tools/protocol_run.py``).

The reference's run of record (training_patches_saves/training_logs/
training_test_log.log + README.md): mode paper_obj, batch 24, patch 224,
608^2 tiles, 2,410 victim-pseudo-labeled train images -> 101 batches per
epoch, up to 401 epochs, Adam(amsgrad) lr 0.03 with
ReduceLROnPlateau(patience=50), then the creation-metrics evaluation
(test_patch_DOTA_metrics.py:301-377) on held-out scenes. This tool runs
that whole schedule end to end through the port's CLIs:

  1. trim the pseudo-labeled trainset to exactly --train-images (2,410,
     the count of record), deterministically (sorted, first N);
  2. leg 1: ``cli.train_patch --device-store`` for epochs [0, break);
  3. leg 2: the same command with ``--resume`` for [break, epochs): a
     fresh ``PatchTrainer`` and ``DeviceStore`` restored from ``ckpt.pt``
     (so break - 1 must lie on the every-20 checkpoint grid);
  4. paste + detect on the held-out set for the trained patch and a
     random-patch control (same placement machinery, seed and ground
     truth);
  5. ``cli.test_patch_metrics --json`` for both;
  6. write <out>/protocol_summary.json: steps/min, epoch-loss curve
     stats, every plateau-scheduler LR decay with its epoch, resume
     evidence, and the M1/M2/M4/mAP table.

Inputs are directories produced by ``cli.images_filter`` (see
``tools.protocol_prep``). Unlike the repository's tool, which runs each
CLI as a subprocess, this one calls each CLI module's ``main(argv)`` in
its own process and appends what it prints to ``<out>/cli.log``
(``attack_quality._run_cli``: the built kernels and the CUDA context are
reused, a caller can count the kernels' launches, the card's cached
memory is released between legs). ``--device`` (default cuda; raises
where there is no card) goes to every CLI that takes one.

    python -m <package>.tools.protocol_run \
        --train-set DIR/train_set --gt DIR/gt \
        --cfgfile tests/fixtures/refparity_full/yolov3_dota_synth.cfg \
        --weightfile tests/fixtures/refparity_full/yolov3_dota_synth.weights \
        --out DIR/run
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from .. import train as T
from ..cli import test_patch, test_patch_metrics, train_patch
from ..ops._cuda import resolve_device
from .attack_quality import _extract_json, _run_cli, write_control_patch


def trim_trainset(train_set: str, n: int) -> int:
    """Deterministically trim the filtered trainset to exactly n images
    (sorted, first n); extras move to <train_set>/excess_* so the run
    matches the reference's 2,410-image count of record exactly."""
    img_dir = os.path.join(train_set, "images")
    files = sorted(os.listdir(img_dir))
    if len(files) < n:
        raise SystemExit(f"trainset has {len(files)} < {n} images — "
                         f"synthesize/filter more scenes first")
    for sub in ("images", "yolo-labels", "yolo-labels_w_conf"):
        os.makedirs(os.path.join(train_set, "excess_" + sub),
                    exist_ok=True)
    for name in files[n:]:
        stem = os.path.splitext(name)[0]
        for sub, fname in (("images", name),
                           ("yolo-labels", stem + ".txt"),
                           ("yolo-labels_w_conf", stem + ".txt")):
            src = os.path.join(train_set, sub, fname)
            if os.path.exists(src):
                shutil.move(src, os.path.join(train_set, "excess_" + sub,
                                              fname))
    return len(files[:n])


def schedule_summary(train_log: str, n_batches: int,
                     resume_break: int) -> dict:
    """The schedule evidence of a run's ``train_log.jsonl``: epochs and
    steps run, the epoch-loss curve's first / min / last, every plateau
    LR decay with its epoch, the steady epoch time (epochs 2 on) and its
    steps/min at ``n_batches`` a epoch."""
    with open(train_log) as f:
        hist = [json.loads(line) for line in f]
    # the resumed leg re-logs from the checkpoint epoch; keep the last
    # record per epoch (the one that actually produced the final patch)
    by_epoch = {}
    for h in hist:
        by_epoch[h["epoch"]] = h
    epochs_run = sorted(by_epoch)
    lr_decays = []
    prev_lr = None
    for e in epochs_run:
        lr = by_epoch[e]["lr"]
        if prev_lr is not None and lr < prev_lr:
            lr_decays.append({"epoch": e, "lr": lr})
        prev_lr = lr
    total_steps = sum(by_epoch[e]["num_batches"] for e in epochs_run)
    steady = [by_epoch[e]["epoch_time"] for e in epochs_run[2:]]
    steps_min = (n_batches * 60.0 / (sum(steady) / len(steady))
                 if steady else 0.0)
    return {
        "epochs_run": len(epochs_run),
        "first_epoch": epochs_run[0], "last_epoch": epochs_run[-1],
        "total_steps": total_steps,
        "loss_first": by_epoch[epochs_run[0]]["loss"],
        "loss_min": min(by_epoch[e]["loss"] for e in epochs_run),
        "loss_last": by_epoch[epochs_run[-1]]["loss"],
        "lr_decays": lr_decays,
        "steady_epoch_seconds": round(sum(steady) / max(len(steady), 1),
                                      2),
        "steps_per_min_steady": round(steps_min, 1),
        "resumed_at": resume_break,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-set", required=True,
                    help="images_filter output dir (images/ + labels)")
    ap.add_argument("--gt", required=True,
                    help="held-out images_filter output dir")
    ap.add_argument("--cfgfile", required=True)
    ap.add_argument("--weightfile", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--img-size", type=int, default=608)
    ap.add_argument("--patch-size", type=int, default=224)
    ap.add_argument("--train-images", type=int, default=2410,
                    help="trainset size of record")
    ap.add_argument("--epochs", type=int, default=401,
                    help="schedule of record")
    ap.add_argument("--resume-break", type=int, default=201,
                    help="end leg 1 after this many epochs (break-1 "
                         "must hit the every-20 checkpoint grid so leg "
                         "2 resumes exactly there)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    every = T.get_experiment("paper_obj").checkpoint_every
    if not (0 < args.resume_break < args.epochs
            and (args.resume_break - 1) % every == 0):
        ap.error(f"--resume-break {args.resume_break}: break - 1 must lie "
                 f"on the every-{every} checkpoint grid, below --epochs "
                 f"{args.epochs}")
    resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    log = os.path.join(args.out, "cli.log")
    run_dir = os.path.join(args.out, "train")
    summary = {"protocol": "paper_obj b24 full schedule",
               "epochs": args.epochs, "train_images": args.train_images,
               "resume_break": args.resume_break, "seed": args.seed}

    kept = trim_trainset(args.train_set, args.train_images)
    n_batches = -(-args.train_images // 24)
    print(f"[1/5] trainset trimmed to {kept} images "
          f"({n_batches} b24 batches/epoch; reference: 2,410 / 101)",
          flush=True)
    summary["batches_per_epoch"] = n_batches

    train_args = [
        "--mode", "paper_obj",
        "--cfgfile", args.cfgfile, "--weightfile", args.weightfile,
        "--img-dir", os.path.join(args.train_set, "images"),
        "--lab-dir", os.path.join(args.train_set, "yolo-labels"),
        "--img-size", args.img_size, "--patch-size", args.patch_size,
        "--seed", args.seed, "--device-store", "--out-dir", run_dir,
        "--device", args.device]

    t0 = time.time()
    print(f"[2/5] train leg 1: epochs 0..{args.resume_break - 1}",
          flush=True)
    _run_cli(train_patch.main,
             train_args + ["--epochs", args.resume_break], log)
    t_leg1 = time.time() - t0

    print(f"[3/5] train leg 2 (--resume): "
          f"epochs {args.resume_break}..{args.epochs - 1}", flush=True)
    t0 = time.time()
    leg2 = _run_cli(train_patch.main,
                    train_args + ["--epochs", args.epochs, "--resume"], log)
    t_leg2 = time.time() - t0
    if f"resumed at epoch {args.resume_break}\n" not in leg2:
        raise RuntimeError(f"leg 2 did not resume at epoch "
                           f"{args.resume_break} (see {log})")
    summary["train_seconds"] = {"leg1": round(t_leg1, 1),
                                "leg2": round(t_leg2, 1)}

    # -- schedule evidence from the JSONL epoch log --------------------
    sched = schedule_summary(os.path.join(run_dir, "train_log.jsonl"),
                             n_batches, args.resume_break)
    summary["schedule"] = sched
    print(f"    schedule: {sched['epochs_run']} epochs, "
          f"{sched['total_steps']} steps, "
          f"{sched['steps_per_min_steady']:.0f} steps/min steady, "
          f"LR decays: {sched['lr_decays']}", flush=True)

    # -- eval: trained patch vs random control -------------------------
    ctrl_png = os.path.join(args.out, "random_patch.png")
    write_control_patch(ctrl_png, args.patch_size)

    model_args = ["--cfgfile", args.cfgfile,
                  "--weightfile", args.weightfile,
                  "--img-size", args.img_size, "--device", args.device]
    results = {}
    for name, png in (("trained",
                       os.path.join(run_dir, "final_patch.png")),
                      ("random", ctrl_png)):
        print(f"[4/5] test_patch ({name})", flush=True)
        _run_cli(test_patch.main, model_args + [
            "--patch", png, "--patch-size", args.patch_size,
            "--img-dir", os.path.join(args.gt, "images"),
            "--lab-dir", os.path.join(args.gt, "yolo-labels_w_conf"),
            "--out-dir", os.path.join(args.out, f"attacked_{name}"),
            "--seed", args.seed], log)
        print(f"[5/5] metrics ({name})", flush=True)
        results[name] = _extract_json(_run_cli(test_patch_metrics.main, [
            "--pred-dir", os.path.join(args.out, f"attacked_{name}"),
            "--gt-dir", args.gt, "--json"], log))
    summary["results"] = results

    cols = ("M1_avg_instances_created_04", "M1_avg_instances_created_001",
            "M2_avg_conf_created_001", "mAP")
    print("\n| patch | M1@0.4 | M1@0.01 | M2@0.01 | mAP |")
    print("|---|---|---|---|---|")
    for name in ("random", "trained"):
        r = results[name]
        print("| " + " | ".join(
            [name] + ["-" if r.get(c) is None else f"{r[c]:.3f}"
                      for c in cols]) + " |")

    path = os.path.join(args.out, "protocol_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\nwrote {path}")
    return summary


if __name__ == "__main__":
    main()
