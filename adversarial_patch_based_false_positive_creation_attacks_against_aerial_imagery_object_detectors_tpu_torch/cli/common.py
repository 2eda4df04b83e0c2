"""Shared CLI plumbing: argument groups and victim-detector construction."""

from __future__ import annotations

import argparse

import torch

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
