"""The planar activation layout and its conversion kernels (K3a, K3b).

A planar tensor is ``[B, H, C', Wl]``: per image row, channels on the
second-minor axis and image columns on the minor one, shifted right by
one (value ``w`` at lane ``w + 1``, a zero border for 3x3 taps) and
zero-padded to ``Wl = round_up(W + 2, 128)``; ``c_pad`` zero-pads the
channels. It is the JAX package's TPU layout (``ops/planar_conv.py``
``to_planar``), kept exactly so that the fused stem's input and output
compare element for element with the Pallas kernels.

``to_planar`` / ``from_planar`` are the kernel wrappers: on a CUDA
tensor they launch the hand-written kernels of ``csrc/planar.cu``
(replacing the Pallas ``to_planar_mxu`` / ``from_planar_mxu``), on a CPU
tensor they run ``to_planar_plain`` / ``from_planar_plain``. Both are
bound by bytes on the H100. ``step``/``offset`` fold a column decimation
into ``to_planar`` (step 2, offset 0/1: the even/odd column phases that
``stem_fused.split_phases`` builds).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _planar_geometry(w_in: int, c: int, c_pad: Optional[int], step: int,
                     offset: int):
    w_out = (w_in - offset + step - 1) // step
    return w_out, _round_up(w_out + 2, 128), max(c_pad or c, c)


def to_planar_plain(x: torch.Tensor, c_pad: Optional[int] = None,
                    step: int = 1, offset: int = 0) -> torch.Tensor:
    """[B, H, W, C] NHWC -> [B, H, C', Wl] planar of columns
    ``offset, offset + step, ...`` (plain PyTorch)."""
    _, _, w_in, c = x.shape
    w_out, wl, cp = _planar_geometry(w_in, c, c_pad, step, offset)
    xp = x[:, :, offset::step].permute(0, 1, 3, 2)
    return F.pad(xp, (1, wl - w_out - 1, 0, cp - c)).contiguous()


def from_planar_plain(xp: torch.Tensor, w_img: Optional[int] = None,
                      c: Optional[int] = None) -> torch.Tensor:
    """[B, H, C', Wl] planar -> [B, H, W, C] NHWC (plain PyTorch).
    ``w_img`` defaults to H (square images)."""
    w_img = w_img if w_img is not None else xp.shape[1]
    c = c if c is not None else xp.shape[2]
    return xp[:, :, :c, 1:w_img + 1].permute(0, 1, 3, 2).contiguous()


def to_planar(x: torch.Tensor, c_pad: Optional[int] = None,
              step: int = 1, offset: int = 0) -> torch.Tensor:
    """``to_planar_plain`` as the K3a kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return to_planar_plain(x, c_pad, step, offset)
    _cuda.require_cuda("to_planar", x)
    b, h, w_in, c = x.shape
    w_out, wl, cp = _planar_geometry(w_in, c, c_pad, step, offset)
    out = torch.empty((b, h, cp, wl), dtype=x.dtype, device=x.device)
    err = _cuda.lib("planar").apfp_to_planar(
        x.data_ptr(), out.data_ptr(), _cuda.DTYPE_CODES[x.dtype], b, h,
        w_in, c, cp, wl, step, offset, w_out, _cuda.stream_ptr(x))
    _cuda.check(err, "to_planar")
    to_planar.launches += 1
    return out


def from_planar(xp: torch.Tensor, w_img: Optional[int] = None,
                c: Optional[int] = None) -> torch.Tensor:
    """``from_planar_plain`` as the K3b kernel on a CUDA tensor."""
    if xp.device.type == "cpu":
        return from_planar_plain(xp, w_img, c)
    _cuda.require_cuda("from_planar", xp)
    b, h, cp, wl = xp.shape
    w_img = w_img if w_img is not None else h
    c = c if c is not None else cp
    if w_img + 1 > wl or c > cp or b * h > 65535:
        raise ValueError(f"from_planar: bad geometry {xp.shape}, "
                         f"w_img={w_img}, c={c}")
    out = torch.empty((b, h, w_img, c), dtype=xp.dtype, device=xp.device)
    err = _cuda.lib("planar").apfp_from_planar(
        xp.data_ptr(), out.data_ptr(), _cuda.DTYPE_CODES[xp.dtype], b, h,
        cp, wl, w_img, c, _cuda.stream_ptr(xp))
    _cuda.check(err, "from_planar")
    from_planar.launches += 1
    return out


to_planar.launches = 0
from_planar.launches = 0
