"""Shared CLI plumbing: argument groups, victim-detector construction and
the image directories the eval CLIs walk."""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from ..data.dataset import load_image_rgb, pad_and_scale
from ..evals.detect import Detector
from ..models import (build_network, init_params, load_darknet_weights,
                      network_from_cfg, yolov3_blocks)


def add_model_args(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("victim detector")
    g.add_argument("--cfgfile", default=None,
                   help="darknet .cfg (default: built-in yolov3-dota)")
    g.add_argument("--weightfile", default=None,
                   help="darknet .weights (default: random init)")
    g.add_argument("--img-size", type=int, default=608)
    g.add_argument("--num-classes", type=int, default=15)
    g.add_argument("--fp32", action="store_true",
                   help="run the detector in float32 instead of bfloat16")
    g.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises if missing)")


def build_detector(args) -> Detector:
    if args.cfgfile:
        net = network_from_cfg(args.cfgfile)
    else:
        net = build_network(yolov3_blocks(
            num_classes=args.num_classes, width=args.img_size,
            height=args.img_size))
    if args.weightfile:
        params, _ = load_darknet_weights(net, args.weightfile)
    else:
        print("WARNING: no --weightfile given; using random-init weights "
              "(detections will be meaningless)", flush=True)
        params = init_params(net, 0)
    return Detector(
        net, params, img_size=args.img_size,
        num_classes=args.num_classes,
        compute_dtype=torch.float32 if args.fp32 else torch.bfloat16,
        device=args.device)


def list_images(img_dir: str) -> List[str]:
    """The .png / .jpg file names of ``img_dir``, sorted."""
    return sorted(f for f in os.listdir(img_dir)
                  if f.lower().endswith((".png", ".jpg")))


def load_scaled(path: str, img_size: int) -> np.ndarray:
    """An image square-padded (gray 127) and resized: [S, S, 3] float32
    in [0, 1]."""
    arr, _ = pad_and_scale(load_image_rgb(path),
                           np.zeros((0, 5), np.float32), img_size)
    return arr
