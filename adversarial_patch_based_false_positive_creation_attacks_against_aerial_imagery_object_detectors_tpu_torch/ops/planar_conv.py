"""The planar activation layout, its conversion kernels (K3a, K3b) and the
generic planar conv (K4).

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

``planar_conv`` is one conv layer on planar activations (3x3 stride 1 or
2, or 1x1; + bias, optional leaky, optional residual, optional leaky-
backward gate), the Pallas ``planar_conv``: on a CUDA tensor the K4
kernel of ``csrc/planar_conv.cu``, on a CPU tensor ``planar_conv_plain``.
It carries the per-layer planar stem (``models/stem_planar.py``) and the
per-layer planar 152^2 stage (``models/res_planar.py``), forward and
backward; ``expand2_planar`` is the stride-2 adjoint's zero interleave,
``flip_t`` a stride-1 conv's adjoint kernel.
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
    """``to_planar_plain`` as the K3a kernel on a CUDA tensor: the tiled
    transpose for C >= 32 (coalesced reads of wide rows), one thread per
    output element otherwise. Each variant counts its own launches:
    ``to_planar.launches`` and ``to_planar.tiled_launches``."""
    if x.device.type == "cpu":
        return to_planar_plain(x, c_pad, step, offset)
    return _to_planar_launch(x, c_pad, step, offset, tiled=x.shape[3] >= 32)


def _to_planar_launch(x: torch.Tensor, c_pad: Optional[int], step: int,
                      offset: int, tiled: bool) -> torch.Tensor:
    _cuda.require_cuda("to_planar", x)
    b, h, w_in, c = x.shape
    w_out, wl, cp = _planar_geometry(w_in, c, c_pad, step, offset)
    out = torch.empty((b, h, cp, wl), dtype=x.dtype, device=x.device)
    fn = (_cuda.lib("planar").apfp_to_planar_tiled if tiled
          else _cuda.lib("planar").apfp_to_planar)
    err = fn(x.data_ptr(), out.data_ptr(), _cuda.DTYPE_CODES[x.dtype], b, h,
             w_in, c, cp, wl, step, offset, w_out, _cuda.stream_ptr(x))
    _cuda.check(err, "to_planar")
    if tiled:
        to_planar.tiled_launches += 1
    else:
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
to_planar.tiled_launches = 0
from_planar.launches = 0


# ---------------------------------------------------------------------------
# The generic planar conv (K4) and the stride-2 adjoint's layout op
# ---------------------------------------------------------------------------

def expand2_planar(xp: torch.Tensor, w_img: int) -> torch.Tensor:
    """Zero-interleave rows and image columns: planar [B, H, C, Wl] at
    (H, W) -> planar [B, 2H, C, Wl'] at (2H, 2W) with value (i, j) at
    (2i, 2j): the exact adjoint of a stride-2 conv's even-index
    decimation, so ``planar_conv(expand2_planar(g), flip_t(w), 0, k=3,
    slope=None)`` is the input cotangent of ``planar_conv(x, w, b, k=3,
    stride=2)``. A layout op in plain PyTorch (the JAX package's is too)."""
    b, h, c, _ = xp.shape
    wl2 = _round_up(2 * w_img + 2, 128)
    out = xp.new_zeros((b, 2 * h, c, wl2))
    out[:, ::2, :, 1:2 * w_img + 1:2] = xp[:, :, :, 1:w_img + 1]
    return out


def flip_t(w: torch.Tensor) -> torch.Tensor:
    """HWIO kernel of a stride-1 conv's input cotangent: spatial flip and
    the two channel axes swapped (contiguous)."""
    return torch.flip(w, (0, 1)).permute(0, 1, 3, 2).contiguous()


def leaky_bwd_planar(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Planar leaky backward from the activation's sign (leaky keeps the
    sign): ``g * where(y > 0, 1, 0.1)`` in g's dtype; the cotangent's zero
    borders stay zero."""
    return g * torch.where(y > 0, 1.0, 0.1).to(g.dtype)


def pad_cin(w: torch.Tensor, cin: int) -> torch.Tensor:
    """HWIO ``w`` with its input channels zero-padded to ``cin`` (a
    channel-padded planar input, e.g. C = 3 stored as 8)."""
    return F.pad(w, (0, 0, 0, cin - w.shape[2])) if w.shape[2] < cin else w


def pad_cout(w: torch.Tensor, m: int = 8) -> torch.Tensor:
    """HWIO ``w`` with its output channels zero-padded to a multiple of
    ``m`` (the JAX package's ``_pad_cout``)."""
    extra = (-w.shape[-1]) % m
    return F.pad(w, (0, extra)) if extra else w


def _conv_geometry(xp, w, k, stride, w_img):
    """(h_out, w_out, wl_out) of ``planar_conv``; raises on a geometry the
    Pallas kernel does not take either."""
    _, h_in, cin, wl_in = xp.shape
    if (k, stride) not in ((1, 1), (3, 1), (3, 2)):
        raise ValueError(f"planar_conv: k={k}, stride={stride} (1x1 s1 or "
                         "3x3 s1/s2)")
    if (w.dim() != 4 or tuple(w.shape[:2]) != (k, k)
            or w.shape[2] > cin):
        raise ValueError(f"planar_conv: weight {tuple(w.shape)} for k={k}, "
                         f"cin={cin}")
    if wl_in != _round_up(w_img + 2, 128) or (
            stride == 2 and (h_in % 2 or w_img % 2)):
        raise ValueError(f"planar_conv: bad planar geometry {tuple(xp.shape)}"
                         f" for w_img={w_img}, stride={stride}")
    h_out, w_out = h_in // stride, w_img // stride
    return h_out, w_out, _round_up(w_out + 2, 128)


def planar_conv_plain(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      res: Optional[torch.Tensor] = None, *, k: int,
                      stride: int = 1, slope: Optional[float] = 0.1,
                      w_img: Optional[int] = None,
                      gate: Optional[torch.Tensor] = None,
                      gate_slope: float = 0.1) -> torch.Tensor:
    """K4's plain version, with the Pallas kernel's rounding points:
    float32 accumulation, + bias, leaky as ``max(y, slope y)`` (skipped
    for ``slope=None``), for stride 2 a rounding to the dtype (the kernel
    rounds before its even-index decimation), + ``res``, then
    ``* where(gate > 0, 1, gate_slope)``, all in float32, and one cast at
    the store. Border and padding lanes are zero."""
    dt = xp.dtype
    w_img = w_img if w_img is not None else xp.shape[1]
    h_out, w_out, wl_out = _conv_geometry(xp, w, k, stride, w_img)
    cin = xp.shape[2]
    x = xp[:, :, :, 1:w_img + 1].permute(0, 2, 1, 3).float()
    wt = pad_cin(w, cin).permute(3, 2, 0, 1).float()
    with _cuda.no_tf32():
        y = F.conv2d(x, wt, None, stride, (k - 1) // 2)
    y = y + b.float().view(1, -1, 1, 1)
    if slope is not None:
        y = torch.maximum(y, y * slope)
    if stride == 2:
        y = y.to(dt).float()
    y = y.permute(0, 2, 1, 3)                  # [B, H', cout, W']
    if res is not None:
        y = y + res[:, :, :, 1:w_out + 1].float()
    if gate is not None:
        g = gate[:, :, :, 1:w_out + 1].float()
        y = torch.where(g > 0, y, y * gate_slope)
    return F.pad(y.to(dt), (1, wl_out - w_out - 1)).contiguous()


def planar_conv(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                res: Optional[torch.Tensor] = None, *, k: int,
                stride: int = 1, slope: Optional[float] = 0.1,
                w_img: Optional[int] = None,
                gate: Optional[torch.Tensor] = None,
                gate_slope: float = 0.1) -> torch.Tensor:
    """Conv + bias + leaky (+ residual, + gate) on planar activations, the
    JAX package's ``planar_conv``: ``xp`` [B, H, cin, Wl] planar, ``w``
    HWIO [k, k, cin', cout] (cin' <= cin: a channel-padded input's weights
    are zero-padded), ``b`` [cout], ``res`` and ``gate`` planar
    [B, H/stride, cout, Wl'] or None; ``w_img`` defaults to H. Returns
    [B, H/stride, cout, Wl'] planar in xp's dtype. On a CUDA tensor it
    launches the K4 kernel of ``csrc/planar_conv.cu``, each geometry
    counting its own launches (``planar_conv.launches_k1``,
    ``.launches_k3``, ``.launches_k3s2``); on a CPU tensor it runs
    ``planar_conv_plain``."""
    if xp.device.type == "cpu":
        return planar_conv_plain(xp, w, b, res, k=k, stride=stride,
                                 slope=slope, w_img=w_img, gate=gate,
                                 gate_slope=gate_slope)
    opt = [t for t in (res, gate) if t is not None]
    _cuda.require_cuda("planar_conv", xp, *opt)
    dt = xp.dtype
    batch, h_in, cin, wl_in = xp.shape
    w_img = w_img if w_img is not None else h_in
    h_out, w_out, wl_out = _conv_geometry(xp, w, k, stride, w_img)
    cout = w.shape[-1]
    shape = (batch, h_out, cout, wl_out)
    for name, t in (("res", res), ("gate", gate)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dt):
            raise ValueError(f"planar_conv: {name} {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dt}")
    if tuple(b.shape) != (cout,) or w.device != xp.device \
            or b.device != xp.device:
        raise ValueError(f"planar_conv: bias {tuple(b.shape)} on {b.device}"
                         f" / weight on {w.device} for cout={cout} on "
                         f"{xp.device}")
    # the kernel's weight layout: cin as the input's, cout a multiple of 8
    # (no copy where the caller prepared it so)
    wk = pad_cout(pad_cin(w, cin)).to(dt).contiguous()
    cout_pad = wk.shape[-1]
    bk = b.float().contiguous()
    if cout_pad > cout:
        bk = F.pad(bk, (0, cout_pad - cout))
    out = torch.empty(shape, dtype=dt, device=xp.device)
    err = _cuda.lib("planar_conv").apfp_planar_conv(
        xp.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        res.data_ptr() if res is not None else None,
        gate.data_ptr() if gate is not None else None, out.data_ptr(),
        _cuda.DTYPE_CODES[dt], batch, h_in, cin, wl_in, w_img, cout,
        cout_pad, k, stride, int(slope is not None),
        float(slope if slope is not None else 0.0), float(gate_slope),
        _cuda.stream_ptr(xp))
    _cuda.check(err, "planar_conv")
    if k == 1:
        planar_conv.launches_k1 += 1
    elif stride == 1:
        planar_conv.launches_k3 += 1
    else:
        planar_conv.launches_k3s2 += 1
    return out


planar_conv.launches_k1 = 0
planar_conv.launches_k3 = 0
planar_conv.launches_k3s2 = 0
