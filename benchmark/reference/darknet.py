"""Plain float32 darknet forward for the benchmark's configurations.

``yolov3_blocks`` is the layer graph of darknet's cfg/yolov3.cfg (75
convolutions, 23 shortcuts, 4 routes, 2 upsamples, 3 yolo layers),
written out again here from the published cfg; ``tiny_blocks`` is the
small graph the benchmark's CPU tests run. ``forward`` walks a block list
with ``F.conv2d`` in float32 (TF32 off) and returns the raw heads NHWC.
Weights are the benchmark's (``benchmark.weights``), folded: per conv an
OIHW kernel and a bias.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LEAKY = 0.1
BN_EPS = 1e-5


def _conv(filters, size, stride=1, bn=True, act="leaky"):
    return {"type": "conv", "filters": filters, "size": size,
            "stride": stride, "bn": bn, "act": act}


def yolov3_blocks(num_classes: int) -> List[dict]:
    """darknet cfg/yolov3.cfg's graph after the [net] block."""
    head = 3 * (5 + num_classes)
    b = [_conv(32, 3)]
    for filters, n_res in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        b.append(_conv(filters, 3, 2))
        for _ in range(n_res):
            b += [_conv(filters // 2, 1), _conv(filters, 3),
                  {"type": "shortcut", "from": -3}]
    for scale, (wide, route) in enumerate(((1024, None), (512, 61),
                                           (256, 36))):
        if route is not None:
            b += [{"type": "route", "layers": [-4]}, _conv(wide // 2, 1),
                  {"type": "upsample", "stride": 2},
                  {"type": "route", "layers": [-1, route]}]
        for _ in range(3):
            b += [_conv(wide // 2, 1), _conv(wide, 3)]
        b.append(_conv(head, 1, bn=False, act="linear"))
        b.append({"type": "yolo", "scale": scale})
    return b


def tiny_blocks(num_classes: int) -> List[dict]:
    """A three-head graph with every block kind, for the CPU tests."""
    head = 3 * (5 + num_classes)
    return [
        _conv(8, 3), _conv(16, 3, 2), _conv(8, 1), _conv(16, 3),
        {"type": "shortcut", "from": -3}, _conv(32, 3, 2),
        {"type": "maxpool", "size": 2, "stride": 2}, _conv(32, 3),
        _conv(64, 3, 2), _conv(64, 3, 2),
        _conv(32, 1), _conv(head, 1, bn=False, act="linear"),
        {"type": "yolo", "scale": 0},
        {"type": "route", "layers": [-3]}, _conv(16, 1),
        {"type": "upsample", "stride": 2}, {"type": "route", "layers": [-1, 8]},
        _conv(32, 3), _conv(head, 1, bn=False, act="linear"),
        {"type": "yolo", "scale": 1},
        {"type": "route", "layers": [-3]}, _conv(16, 1),
        {"type": "upsample", "stride": 2}, {"type": "route", "layers": [-1, 7]},
        _conv(32, 3), _conv(head, 1, bn=False, act="linear"),
        {"type": "yolo", "scale": 2},
    ]


ARCHITECTURES = {"yolov3": yolov3_blocks, "tiny": tiny_blocks}


def blocks_for(config: dict) -> List[dict]:
    return ARCHITECTURES[config["architecture"]](config["num_classes"])


def conv_shapes(blocks: List[dict], in_ch: int = 3
                ) -> List[Tuple[int, int, int, int, int, bool]]:
    """(block index, in channels, filters, size, stride, bn) of every
    convolution."""
    chans: List[int] = []
    out = []
    for i, blk in enumerate(blocks):
        kind = blk["type"]
        if kind == "conv":
            cin = chans[-1] if chans else in_ch
            out.append((i, cin, blk["filters"], blk["size"], blk["stride"],
                        blk["bn"]))
            chans.append(blk["filters"])
        elif kind == "route":
            chans.append(sum(chans[i + r if r < 0 else r]
                             for r in blk["layers"]))
        else:
            chans.append(chans[-1])
    return out


def conv_flops_per_image(blocks: List[dict], size: int) -> float:
    """Forward conv FLOPs (2 x multiply-adds) of one square image."""
    hw: List[int] = []
    cur = size
    total = 0.0
    shapes = {i: s for i, *s in conv_shapes(blocks)}
    for i, blk in enumerate(blocks):
        kind = blk["type"]
        if kind == "conv":
            cin, cout, k, stride, _ = shapes[i]
            cur = -(-cur // stride)
            total += 2.0 * cur * cur * cout * cin * k * k
        elif kind == "maxpool":
            cur = -(-cur // blk["stride"])
        elif kind == "upsample":
            cur *= blk["stride"]
        elif kind == "route":
            r = blk["layers"][0]
            cur = hw[i + r if r < 0 else r]
        hw.append(cur)
    return total


@contextlib.contextmanager
def full_float32():
    """float32 matmuls and convolutions without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# float formats of the lower precisions: (dtype, largest finite value)
FP8 = {"fp8": (torch.float8_e4m3fn, 448.0),
       "e5m2": (torch.float8_e5m2, 57344.0)}


def round_to(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``x`` rounded to ``quant``, back in float32, with the
    straight-through gradient: "fp8" (e4m3), "e5m2" or "int8" under one
    per-tensor scale (the largest magnitude to the format's largest),
    "bf16", or None (float32, unchanged)."""
    if quant is None:
        return x
    if quant == "bf16":
        q = x.to(torch.bfloat16).float()
    else:
        amax = x.detach().abs().amax().clamp(min=1e-12)
        if quant == "int8":
            scale = amax / 127.0
            q = torch.round(x / scale).clamp(-127, 127) * scale
        else:
            dtype, top = FP8[quant]
            scale = amax / top
            q = (x / scale).to(dtype).to(torch.float32) * scale
    return x + (q - x).detach()


def forward(blocks: List[dict], weights: Dict[int, Tuple[torch.Tensor,
                                                         torch.Tensor]],
            x: torch.Tensor, quant: Optional[str] = None,
            calibrate: Optional[float] = None) -> List[torch.Tensor]:
    """Raw heads [B, S, S, 3*(5+C)] float32 of NHWC ``x`` in [0, 1].

    ``quant`` ("fp8" or "bf16") rounds to that format every value the
    program stores: the input, each kernel and bias, each conv's output,
    the biased sum, the activation and each shortcut's sum.
    ``calibrate=beta`` folds into each batch-normalised conv of
    ``weights`` (in place) a batch norm whose mean and variance are the
    per-channel statistics of its output over ``x``, with gamma 1 and
    the shift ``beta``."""
    prev = round_to(x.float().permute(0, 3, 1, 2), quant)
    outs: List[torch.Tensor] = []
    heads: List[torch.Tensor] = []
    with full_float32():
        for i, blk in enumerate(blocks):
            kind = blk["type"]
            if kind == "conv":
                w, bias = weights[i]
                y = F.conv2d(prev, round_to(w, quant), None, blk["stride"],
                             (blk["size"] - 1) // 2)
                if calibrate is not None and blk["bn"]:
                    mean = y.mean(dim=(0, 2, 3))
                    scale = torch.rsqrt(y.var(dim=(0, 2, 3), correction=0)
                                        + BN_EPS)
                    bias = (bias - mean) * scale + calibrate
                    weights[i] = (w * scale[:, None, None, None], bias)
                    y = y * scale[None, :, None, None]
                y = round_to(round_to(y, quant)
                           + round_to(bias, quant)[None, :, None, None], quant)
                if blk["act"] == "leaky":
                    y = round_to(torch.where(y > 0, y, y * LEAKY), quant)
                prev = y
            elif kind == "shortcut":
                prev = round_to(outs[-1] + outs[i + blk["from"]], quant)
            elif kind == "route":
                prev = torch.cat([outs[i + r if r < 0 else r]
                                  for r in blk["layers"]], dim=1)
            elif kind == "upsample":
                prev = F.interpolate(prev, scale_factor=blk["stride"],
                                     mode="nearest")
            elif kind == "maxpool":
                prev = F.max_pool2d(prev, blk["size"], blk["stride"],
                                    padding=(blk["size"] - 1) // 2)
            elif kind == "yolo":
                heads.append(prev.permute(0, 2, 3, 1))
            else:
                raise ValueError(f"unknown block {kind!r}")
            outs.append(prev)
    return heads
