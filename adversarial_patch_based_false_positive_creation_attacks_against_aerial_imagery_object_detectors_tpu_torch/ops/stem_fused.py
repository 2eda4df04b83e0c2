"""The fused YOLOv3 stem forward (K1): layers 0-5 in one kernel.

``fused_stem_fwd`` takes the even/odd column phases of the input in the
planar layout (``split_phases``) and returns y5 planar
``[B, H/4, 128, Wl5]``, exactly as the JAX package's Pallas
``ops/stem_fused.py: fused_stem_fwd`` does. On a CUDA tensor it launches
the hand-written kernel of ``csrc/stem_fused.cu``; on a CPU tensor it
runs ``fused_stem_fwd_plain``, the same function as ``F.conv2d`` chains
with the kernel's rounding points (float32 accumulation; the compute
dtype after each leaky and on the shortcut sum). The kernel is bound by
operations on the H100 (11.2 GFLOP per 608^2 image against ~17.5 MB of
planar I/O); see the source for its design.

``fused_stem`` is the NHWC-in, NHWC-out forward the detector calls:
``split_phases`` (K3a twice) -> K1 -> ``from_planar`` (K3b). Its backward
(the Pallas ``fused_stem_bwd_saved`` and the ``save_acts`` masks) belongs
to the training slice, so an input that requires grad is refused.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .planar_conv import (_round_up, from_planar, from_planar_plain,
                          to_planar, to_planar_plain)

LEAKY = 0.1

STEM_FILTERS = (32, 64, 32, 64, 128)
STEM_IN = (3, 32, 64, 32, 64)
STEM_KSIZE = (3, 3, 1, 3, 3)

StemParams = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def split_phases(x: torch.Tensor):
    """NHWC [B, H, W, C<=8] -> (even-column, odd-column) planar phases,
    each [B, H, 8, round_up(W/2+2, 128)] with value j at lane j+1."""
    return (to_planar(x, c_pad=8, step=2, offset=0),
            to_planar(x, c_pad=8, step=2, offset=1))


def merge_phases(pe: torch.Tensor, po: torch.Tensor, w_half: int,
                 c: int) -> torch.Tensor:
    """Inverse of split_phases -> NHWC [B, H, 2*w_half, c] (plain
    PyTorch, as the JAX package's)."""
    e = from_planar_plain(pe, w_half, c)
    o = from_planar_plain(po, w_half, c)
    b, h = e.shape[:2]
    return torch.stack([e, o], dim=3).reshape(b, h, 2 * w_half, c)


def fused_applicable(net, params, x_shape) -> bool:
    """stem_planar.stem_applicable AND the yolov3 channel widths the
    kernel hard-codes (3->32->64->32->64->128)."""
    from ..models.stem_planar import stem_shape_ok
    return fused_net_applicable(net, params) and stem_shape_ok(x_shape)


def fused_net_applicable(net, params) -> bool:
    """The network and params half of ``fused_applicable``: decided once
    per model, so ``Darknet`` prepares the kernel's weights at build."""
    from ..models.stem_planar import STEM_CONVS, stem_net_applicable
    if not stem_net_applicable(net, params):
        return False
    filters = tuple(net.layers[i].conv.filters for i in STEM_CONVS)
    return filters == STEM_FILTERS


def fused_stem_fwd_plain(xe: torch.Tensor, xo: torch.Tensor,
                         sp: StemParams) -> torch.Tensor:
    """K1's plain version: phase-split planar x -> planar y5. ``sp`` holds
    (HWIO weight in the compute dtype, float32 bias) for convs 0,1,2,3,5
    (``models/stem_planar._stem_params``)."""
    dt = xe.dtype
    x = merge_phases(xe, xo, xe.shape[1] // 2, 3)

    def conv(u, w, bias, stride):
        y = F.conv2d(u, w.permute(3, 2, 0, 1).float(), None, stride,
                     (w.shape[0] - 1) // 2)
        y = y + bias.float().view(1, -1, 1, 1)
        return torch.maximum(y, y * LEAKY).to(dt).float()

    with _cuda.no_tf32():
        v = x.permute(0, 3, 1, 2).float()
        y0 = conv(v, *sp[0], 1)
        y1 = conv(y0, *sp[1], 2)
        y2 = conv(y1, *sp[2], 1)
        y3 = conv(y2, *sp[3], 1)
        s4 = (y3 + y1).to(dt).float()
        y5 = conv(s4, *sp[4], 2).to(dt)
    return to_planar_plain(y5.permute(0, 2, 3, 1))


def _check_stem_params(sp: StemParams, dt: torch.dtype,
                       device: torch.device) -> None:
    """The kernel reads ``sp`` as it is: contiguous HWIO weights in the
    compute dtype and float32 biases, on the input's device."""
    if len(sp) != 5:
        raise ValueError("fused_stem_fwd: expected 5 (w, b) pairs")
    for (w, bias), cout, cin, k in zip(sp, STEM_FILTERS, STEM_IN,
                                       STEM_KSIZE):
        if (tuple(w.shape) != (k, k, cin, cout) or w.dtype != dt
                or w.device != device or not w.is_contiguous()):
            raise ValueError(
                f"fused_stem_fwd: weight {tuple(w.shape)} {w.dtype} on "
                f"{w.device}, expected contiguous {(k, k, cin, cout)} {dt} "
                f"on {device}")
        if (tuple(bias.shape) != (cout,) or bias.dtype != torch.float32
                or bias.device != device or not bias.is_contiguous()):
            raise ValueError(f"fused_stem_fwd: bias {tuple(bias.shape)} "
                             f"{bias.dtype} on {bias.device}, expected "
                             f"float32 ({cout},) on {device}")


def fused_stem_fwd(xe: torch.Tensor, xo: torch.Tensor,
                   sp: StemParams) -> torch.Tensor:
    """Phase-split planar x [B, H, 8, Wlh] -> planar y5
    [B, H/4, 128, Wl5] (square images, H % 4 == 0)."""
    if xe.device.type == "cpu":
        return fused_stem_fwd_plain(xe, xo, sp)
    _cuda.require_cuda("fused_stem_fwd", xe, xo)
    bsz, h, cp, wlh = xe.shape
    dt = xe.dtype
    if (xo.shape != xe.shape or xo.dtype != dt or cp != 8 or h % 4
            or wlh != _round_up(h // 2 + 2, 128)):
        raise ValueError(f"fused_stem_fwd: bad phase geometry {xe.shape}")
    _check_stem_params(sp, dt, xe.device)
    h5 = h // 4
    wl5 = _round_up(h5 + 2, 128)
    # the kernel writes every lane, borders and padding included
    y5 = torch.empty((bsz, h5, 128, wl5), dtype=dt, device=xe.device)
    err = _cuda.lib("stem_fused").apfp_fused_stem_fwd(
        xe.data_ptr(), xo.data_ptr(), *[w.data_ptr() for w, _ in sp],
        *[bias.data_ptr() for _, bias in sp], y5.data_ptr(),
        _cuda.DTYPE_CODES[dt], bsz, h, wlh, wl5, _cuda.stream_ptr(xe))
    _cuda.check(err, "fused_stem_fwd")
    fused_stem_fwd.launches += 1
    return y5


fused_stem_fwd.launches = 0


def fused_stem(x: torch.Tensor, sp: StemParams) -> torch.Tensor:
    """NHWC [B, H, W, 3] (compute dtype) -> NHWC [B, H/4, W/4, 128]:
    split_phases -> fused_stem_fwd -> from_planar. Forward only."""
    if x.requires_grad:
        raise RuntimeError(
            "fused_stem has no backward yet (it belongs to the training "
            "slice); run the conv walk for inputs that require grad")
    xe, xo = split_phases(x)
    y5p = fused_stem_fwd(xe, xo, sp)
    return from_planar(y5p, x.shape[1] // 4, 128)
