"""Convergence-curve comparison against the reference's committed
training log, replicated at mini scale on the port (the repository's
``tools/convergence_compare.py``).

The reference's only quantitative training record is
``training_patches_saves/training_logs/training_test_log.log`` (V100S,
mode paper_obj, batch 24), whose epoch-0 mean loss decomposition is
pinned in BASELINE.md:

    total 7.139 | no_obj 3.964 | no_cls 2.684 | tv 0.356
    colorful 0.134 | nps 4.5e-4

Those numbers are conditioned on the DOTA-trained
``yolov3-dota_110000.weights`` checkpoint and the 2410-tile DOTA
trainset, neither of which is in the repository. What can be replicated
is the experimental protocol, end to end, on the mini victim of the
refparity fixture (``tests/fixtures/refparity/``):

1. synthesize scenes from the victim's training distribution
   (``tools.scenes``),
2. pseudo-label them with the victim itself at conf 0.01 / GT at
   obj>0.4 (the images_filter protocol, reference images_filter.py:
   112-124), in this process on the port's ``Detector``,
3. optimize a patch with the paper_obj recipe (batch 24, lr 0.03,
   Adam-amsgrad, TV 2.5 / NPS 0.01 / target 14) with ``PatchTrainer``
   and log the same per-epoch loss decomposition.

The printed table puts the trajectory next to the reference's anchors.
Patch-intrinsic components (nps, tv, colorful) are victim-independent;
the victim-coupled ones (no_obj, no_cls) share scale by construction but
depend on the detector's statistics.

``--full`` runs the same protocol on the 75-conv yolov3-dota graph
(608^2, patch 224) from ``tests/fixtures/refparity_full``, which is not
committed. ``--device`` defaults to cuda and raises where there is no
card.

    python -m <package>.tools.convergence_compare [epochs] [n_scenes] [--full]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from .. import train as T
from ..evals.detect import Detector
from ..models import darknet, load_darknet_weights
from ..ops._cuda import resolve_device
from .attack_quality import FIXROOT, _release
from .scenes import _palette, make_scene

MAX_LAB = 32

REF_EPOCH0 = {"loss": 7.139, "no_obj": 3.964, "no_cls": 2.684,
              "tv": 0.356, "colorful": 0.134, "nps": 4.5e-4}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("epochs", nargs="?", type=int, default=20)
    ap.add_argument("n_scenes", nargs="?", type=int, default=96)
    ap.add_argument("--full", action="store_true",
                    help="full-scale victim (refparity_full, 608^2, "
                         "patch 224)")
    ap.add_argument("--out", default=None,
                    help="JSON of the table (default "
                         "$TMPDIR/convergence_compare_<scale>.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises if missing)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fix = os.path.join(FIXROOT, "refparity_full" if args.full
                       else "refparity")
    victim = "yolov3_dota_synth" if args.full else "mini_yolov3_dota"
    epochs, n_scenes = args.epochs, args.n_scenes

    weights_path = os.path.join(fix, f"{victim}.weights")
    if not os.path.exists(weights_path):
        sys.exit(f"{weights_path} missing — regenerate with "
                 f"tools/make_refparity_fixture.py"
                 f"{' --full' if args.full else ''}")
    net = darknet.network_from_cfg(os.path.join(fix, f"{victim}.cfg"))
    params, _ = load_darknet_weights(net, weights_path)
    params = darknet.fold_bn(net, params)
    # the full-scale victim trains at 320^2 but its cfg/goldens/record
    # geometry is 608^2 (fully-convolutional net)
    img = 608 if args.full else net.width

    # -- victim-pseudo-labeled training set (images_filter protocol)
    rng = np.random.default_rng(42)
    palette = _palette(np.random.default_rng(7))
    det = Detector(net, params, img_size=img, device=dev)
    images, labels = [], []
    tried = 0
    while len(images) < n_scenes and tried < 4 * n_scenes:
        batch = []
        for _ in range(16):
            scene, _ = make_scene(rng, palette, img=img)
            batch.append(scene.astype(np.float32) / 255.0)
            tried += 1
        dets = det.detect_batch(np.stack(batch), 0.01, 0.4)
        for scene, d in zip(batch, dets):
            if len(d) == 0:
                continue                      # images_filter: drop
            gt = d[d[:, 4] > 0.4]
            lab = np.full((MAX_LAB, 5), 1e-6, np.float32)
            if len(gt) == 0:
                lab[0] = 1.0                  # empty-label sentinel
            else:
                gt = gt[:MAX_LAB]
                lab[:len(gt), 0] = gt[:, 6]
                lab[:len(gt), 1:5] = gt[:, 0:4]
            images.append(scene)
            labels.append(lab)
    del det
    _release()
    images = np.stack(images[:n_scenes])
    labels = np.stack(labels[:n_scenes])
    print(f"trainset: {len(images)} scenes "
          f"({(labels[:, :, 0] != 1e-6).sum()} pseudo-label rows), "
          f"victim={os.path.basename(fix)} @ {img}^2", flush=True)

    # patch 224 @ 608^2 is the reference's geometry of record
    # (patch_config.py:23); the mini victim scales both by ~half
    exp = T.get_experiment(
        "paper_obj", img_size=img,
        patch_size=224 if args.full else 112, max_labels=MAX_LAB,
        compute_dtype="bfloat16", max_epochs=epochs)
    trainer = T.PatchTrainer(exp, net=net, params=params, seed=0,
                             device=dev)

    bsz = exp.batch_size
    n_batches = max(1, len(images) // bsz)

    def make_batches(epoch):
        order = np.random.default_rng(1000 + epoch).permutation(
            len(images))
        for i in range(n_batches):
            sel = order[i * bsz:(i + 1) * bsz]
            yield images[sel], labels[sel]

    _, history = trainer.train(make_batches, epochs=epochs)
    del trainer
    _release()

    cols = ("loss", "no_obj", "no_cls", "tv", "colorful", "nps")
    print("\n| epoch | " + " | ".join(cols) + " |")
    print("|" + "---|" * (len(cols) + 1))
    ref = REF_EPOCH0
    print("| ref ep0 (DOTA victim) | "
          + " | ".join(f"{ref[c]:.3g}" for c in cols) + " |")
    for st in history:
        if st["epoch"] % max(1, epochs // 10) and st["epoch"] != epochs - 1:
            continue
        print(f"| {st['epoch']} | "
              + " | ".join(f"{st[c]:.3g}" for c in cols) + " |")
    scale = "full" if args.full else "mini"
    out = {"reference_epoch0": ref,
           scale: [{k: st[k] for k in cols + ("epoch",)}
                   for st in history]}
    path = args.out or os.path.join(tempfile.gettempdir(),
                                    f"convergence_compare_{scale}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {path}")
    return out


if __name__ == "__main__":
    main()
