"""Plain float32 darknet forward for the benchmark's configurations.

``blocks_for`` reads a configuration's graph from the darknet cfg text
it names (``cfg.parse``: conv, shortcut, route, maxpool, upsample and
yolo layers; leaky, mish and linear activations). ``forward`` walks the
blocks with ``F.conv2d`` in float32 (TF32 off) and returns the raw heads
NHWC in cfg order. Weights are the benchmark's (``benchmark.weights``),
folded: per conv an OIHW kernel and a bias.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cfg

LEAKY = 0.1
BN_EPS = 1e-5


def blocks_for(config: dict) -> List[dict]:
    """The layer blocks of the cfg text a configuration carries
    (``cfg_text``, read beside its file by ``core.read_config``)."""
    return cfg.parse(config["cfg_text"])[1]


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
    """Forward conv FLOPs (2 x multiply-adds) of one square image, each
    layer's side by darknet's output-size rules."""
    hw: List[int] = []
    cur = size
    total = 0.0
    shapes = {i: s for i, *s in conv_shapes(blocks)}
    for i, blk in enumerate(blocks):
        kind = blk["type"]
        if kind == "conv":
            cin, cout, k, stride, _ = shapes[i]
            cur = (cur + 2 * blk["pad"] - k) // stride + 1
            total += 2.0 * cur * cur * cout * cin * k * k
        elif kind == "maxpool":
            cur = (cur + blk["padding"] - blk["size"]) // blk["stride"] + 1
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


def _activate(y: torch.Tensor, act: str, quant: Optional[str]
              ) -> torch.Tensor:
    if act == "leaky":
        return round_to(torch.where(y > 0, y, y * LEAKY), quant)
    if act == "mish":
        return round_to(y * torch.tanh(F.softplus(y)), quant)
    return y


def forward(blocks: List[dict], weights: Dict[int, Tuple[torch.Tensor,
                                                         torch.Tensor]],
            x: torch.Tensor, quant: Optional[str] = None,
            calibrate: Optional[float] = None) -> List[torch.Tensor]:
    """Raw heads [B, S, S, 3*(5+C)] float32 of NHWC ``x`` in [0, 1].

    Activations are darknet's: leaky (slope ``LEAKY``), mish
    (``y * tanh(softplus(y))`` in float32: darknet's
    ``activate_array_mish`` up to float32 rounding) and linear. A maxpool
    pads by darknet's rule: of its total ``padding`` (``size - 1``)
    ``padding // 2`` on the left and top, the rest on the right and
    bottom, with -inf.

    ``quant`` ("fp8" or "bf16") rounds to that format every value the
    program stores: the input, each kernel and bias, each conv's output,
    the biased sum, the output of a leaky or mish activation, and each
    shortcut's sum (and its activation's output).
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
                             blk["pad"])
                if calibrate is not None and blk["bn"]:
                    mean = y.mean(dim=(0, 2, 3))
                    scale = torch.rsqrt(y.var(dim=(0, 2, 3), correction=0)
                                        + BN_EPS)
                    bias = (bias - mean) * scale + calibrate
                    weights[i] = (w * scale[:, None, None, None], bias)
                    y = y * scale[None, :, None, None]
                y = round_to(round_to(y, quant)
                           + round_to(bias, quant)[None, :, None, None], quant)
                prev = _activate(y, blk["act"], quant)
            elif kind == "shortcut":
                src = blk["from"]
                prev = _activate(round_to(outs[-1] + outs[
                    i + src if src < 0 else src], quant), blk["act"], quant)
            elif kind == "route":
                prev = torch.cat([outs[i + r if r < 0 else r]
                                  for r in blk["layers"]], dim=1)
            elif kind == "upsample":
                prev = F.interpolate(prev, scale_factor=blk["stride"],
                                     mode="nearest")
            elif kind == "maxpool":
                pad = blk["padding"]
                prev = F.max_pool2d(
                    F.pad(prev, (pad // 2, pad - pad // 2) * 2,
                          value=float("-inf")), blk["size"], blk["stride"])
            elif kind == "yolo":
                heads.append(prev.permute(0, 2, 3, 1))
            else:
                raise ValueError(f"unknown block {kind!r}")
            outs.append(prev)
    return heads
