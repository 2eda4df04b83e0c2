"""Adversarial-patch training CLI.

    python -m <package>.cli.train_patch --mode paper_obj \
        --img-dir .../trainset/images --lab-dir .../trainset/yolo-labels \
        --weightfile yolov3-dota.weights --out-dir runs/paper_obj

    # smoke / benchmark on synthetic tiles
    python -m <package>.cli.train_patch --synthetic 48 --batch-size 24 \
        --epochs 1

Every experiment mode is available via --mode, and config fields can be
overridden by flag. The training state (patch, optimizer, EOT generator,
plateau schedule) checkpoints every ``checkpoint_every`` epochs and
resumes with --resume. Runs on ``--device`` (default cuda; raises if
missing). The victim's kernel routes stand in for the JAX package's
environment variables: the fused stem is on, ``--planar-stem`` tries the
per-layer planar stem after it (``ADV_PATCH_PLANAR_STEM=1``; a stem of
other widths than YOLOv3's takes it), ``--res152 fused|planar``
runs layers 6-11 on the whole-stage or the per-layer kernels after a
kernel stem (``ADV_PATCH_RES152=fused|1``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import train as T
from ..data.dataset import BatchLoader, DotaDataset, SyntheticData
from ..utils.checkpoint import save_patch_png


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--mode", default="paper_obj",
                    choices=sorted(T.EXPERIMENTS))
    ap.add_argument("--img-dir", default=None)
    ap.add_argument("--lab-dir", default=None)
    ap.add_argument("--cfgfile", default=None)
    ap.add_argument("--weightfile", default=None)
    ap.add_argument("--out-dir", default="runs/patch")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--learning-rate", type=float, default=None)
    ap.add_argument("--patch-size", type=int, default=None)
    ap.add_argument("--img-size", type=int, default=None)
    ap.add_argument("--warp-method", default=None, choices=("mxu", "gather"),
                    help="EOT warp: the matmul-factored warp (default) or "
                         "the exact grid_sample warp")
    ap.add_argument("--loss-recipe", default=None, choices=T.LOSS_RECIPES)
    ap.add_argument("--target-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--debug-nans", action="store_true",
                    help="torch.autograd.set_detect_anomaly (the "
                         "reference's always-on detect_anomaly)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="train on N synthetic tiles instead of files")
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    ap.add_argument("--planar-stem", action="store_true",
                    help="layers 0-5 on the per-layer planar kernels where "
                         "the fused stem does not apply")
    ap.add_argument("--res152", default=None, choices=("fused", "planar"),
                    help="layers 6-11 on the whole-stage kernels or the "
                         "per-layer planar kernels (after a kernel stem)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    overrides = {k: v for k, v in {
        "img_dir": args.img_dir, "lab_dir": args.lab_dir,
        "cfgfile": args.cfgfile, "weightfile": args.weightfile,
        "batch_size": args.batch_size,
        "learning_rate": args.learning_rate,
        "patch_size": args.patch_size, "img_size": args.img_size,
        "warp_method": args.warp_method,
        "loss_recipe": args.loss_recipe,
        "target_id": args.target_id,
        "max_epochs": args.epochs,
    }.items() if v is not None}
    if args.debug_nans:
        overrides["debug_nans"] = True
    exp = T.get_experiment(args.mode, **overrides)

    trainer = T.PatchTrainer(exp, seed=args.seed,
                             checkpoint_dir=args.out_dir, device=args.device,
                             planar_stem=args.planar_stem,
                             res152=args.res152)
    dev = trainer.device
    print(f"mode={exp.name} recipe={exp.loss_recipe} "
          f"batch={exp.batch_size} patch={exp.patch_size} "
          f"lr={exp.learning_rate} target_id={exp.target_id}")
    print(f"device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))
    start_epoch = 0
    if args.resume and os.path.exists(
            os.path.join(args.out_dir, trainer.CHECKPOINT)):
        start_epoch = trainer.restore_checkpoint() + 1
        print(f"resumed at epoch {start_epoch}")

    if args.synthetic:
        data = SyntheticData(args.synthetic, exp.img_size, exp.max_labels)
        n_batches = max(1, args.synthetic // exp.batch_size)

        def make_batches(epoch):
            return [data.batch(exp.batch_size, epoch * 10000 + i)
                    for i in range(n_batches)]
    else:
        ds = DotaDataset(exp.img_dir, exp.lab_dir, exp.max_labels,
                         exp.img_size)
        print(f"{len(ds)} training images")
        loader = BatchLoader(ds, exp.batch_size, shuffle=True,
                             num_workers=args.num_workers, seed=args.seed)

        def make_batches(epoch):
            return loader

    epochs = (args.epochs if args.epochs is not None
              else exp.max_epochs) - start_epoch
    t0 = time.time()
    patch, history = trainer.train(make_batches, epochs=epochs,
                                   start_epoch=start_epoch)
    print(f"total training time: {(time.time() - t0) / 60:.2f} min")

    os.makedirs(args.out_dir, exist_ok=True)
    save_patch_png(patch, os.path.join(args.out_dir, "final_patch.png"))
    with open(os.path.join(args.out_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=1)
    print(f"saved {args.out_dir}/final_patch.png")
    return trainer


if __name__ == "__main__":
    main()
