"""The victim's weights, made from the seed on the device.

He-normal kernels (one ``torch.randn`` call of a generator on the
device, cut into OIHW views) and zero biases on the convs without batch
norm (the detection heads). The batch norm after every other conv takes
the per-channel mean and variance of the conv's output on a calibration
batch of seeded tiles, gamma 1 and beta ``BN_BETA``, and is folded into
the kernel and a bias layer by layer through the reference's float32
forward. The graph is whatever the configuration's cfg holds. On
YOLOv3, identity batch norm lets the 23 residual additions grow the
activations until every head saturates its sigmoids, and no gradient
reaches the patch through the victim; with beta 0 the victim sits at the
edge of chaos and its bfloat16 rounding grows through the layers to
15-35% of the heads. Beta 1 keeps most units on the leaky ReLU's linear
side, as in a trained detector, and bfloat16 within a few percent. Both
the program and the reference are handed these float32 tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .reference import darknet

BN_BETA = 1.0


def make_weights(blocks: List[dict], seed: int, device,
                 calibration: torch.Tensor
                 ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """``{block index: (kernel [O, I, k, k], bias [O])}`` for the convs of
    ``blocks``, batch norm calibrated on ``calibration`` (NHWC in [0, 1])
    and folded."""
    shapes = darknet.conv_shapes(blocks)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(cout * cin * k * k for _, cin, cout, k, _, _ in shapes)
    flat = torch.randn(total, generator=gen, device=device)
    out = {}
    off = 0
    for i, cin, cout, k, _, _ in shapes:
        n = cout * cin * k * k
        out[i] = (flat[off:off + n].view(cout, cin, k, k)
                  * math.sqrt(2.0 / (cin * k * k)),
                  torch.zeros(cout, device=device))
        off += n
    with torch.no_grad():
        darknet.forward(blocks, out, calibration.to(device),
                        calibrate=BN_BETA)
    return out


def victim(config: dict, seed: int, device, calibration_tiles: int = 4):
    """(reference blocks, weights) of a configuration file for a run's
    seed: the calibration batch is ``calibration_tiles`` seeded smooth
    tiles at the configuration's size."""
    from . import inputs
    from .core import derive
    blocks = darknet.blocks_for(config)
    tiles = inputs.smooth_tiles(calibration_tiles, config["img_size"],
                                derive(seed, 8), device)
    return blocks, make_weights(blocks, derive(seed, 1), device,
                                tiles.float() / 255.0)
