"""The 152^2 residual stage (YOLOv3 layers 6-11: conv 1x1 128->64, conv
3x3 64->128, shortcut, twice) in one kernel each way: K6a forward
(``res152_fused``) and K6b saved-mask input backward
(``res152_fused_grad``), the JAX package's Pallas ``ops/res_fused.py``.

Both take and give planar ``[B, H, 128, Wl]`` tensors (``to_planar``'s
layout). ``res152_fused(save=True)`` also returns the int8 signs of the
stored a, post7, c and post10 (the leaky gates the backward needs: only
the patch is differentiated, so the cotangent chain needs gates, never
values). On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/res_fused.cu``), on a CPU tensor its plain version: ``F.conv2d``
chains in float32 that round to the compute dtype where the Pallas kernels
store. The kernels' weights come from ``res_weights``, built once by the
model: the BN-folded HWIO kernels as they are for the forward, and their
flipped, channel-swapped transposes for the backward (the Pallas
kernels' pair and block-diagonal matrices are TPU blocking and are not
ported).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .planar_conv import _round_up, flip_t, to_planar_plain

CIN = 128      # stage width (yolov3); MID = CIN // 2
MID = CIN // 2
LEAKY = 0.1

# (forward HWIO shapes of w6, w7, w9, w10), (backward: w6t, w7t, w9t, w10t)
FWD_SHAPES = ((1, 1, CIN, MID), (3, 3, MID, CIN), (1, 1, CIN, MID),
              (3, 3, MID, CIN))
BWD_SHAPES = ((1, 1, MID, CIN), (3, 3, CIN, MID), (1, 1, MID, CIN),
              (3, 3, CIN, MID))

ResFwd = Sequence[Tuple[torch.Tensor, torch.Tensor]]
ResBwd = Sequence[torch.Tensor]


def res_weights(sp) -> Tuple[list, list]:
    """Both kernels' weights from [(w6, b6), (w7, b7), (w9, b9),
    (w10, b10)] (HWIO in the compute dtype, BN-folded): the forward's
    contiguous (weight, float32 bias) pairs, and the backward's flipped,
    channel-swapped kernels (w6t, w7t, w9t, w10t)."""
    fwd = [(w.contiguous(), b.to(torch.float32).contiguous())
           for w, b in sp]
    return fwd, [flip_t(w) for w, _ in fwd]


def _body(xp: torch.Tensor, w_img: int) -> torch.Tensor:
    """Planar [B, H, C, Wl] -> NCHW float32 of its image lanes."""
    return xp[:, :, :, 1:w_img + 1].permute(0, 2, 1, 3).float()


def _planar(y: torch.Tensor) -> torch.Tensor:
    """NCHW [B, C, H, W] -> planar [B, H, C, Wl] (zero borders)."""
    return to_planar_plain(y.permute(0, 2, 3, 1))


def _conv(u, w):
    return F.conv2d(u, w.permute(3, 2, 0, 1).float(), None, 1,
                    (w.shape[0] - 1) // 2)


def res152_fused_plain(xp: torch.Tensor, fwd: ResFwd, save: bool = False,
                       w_img=None):
    """K6a's plain version, with ``_fwd_kernel``'s roundings: a, post7,
    y8 = post7 + x, c and post10 each stored in the dtype, y11 = post10 +
    y8 summed in float32 and cast; with ``save`` the tuple (y11, am, p7m,
    cm, p10m) whose masks are ``stored > 0`` over all lanes."""
    dt = xp.dtype
    w_img = w_img if w_img is not None else xp.shape[1]

    def rnd(v):
        return v.to(dt).float()

    def layer(u, w, b):
        y = _conv(u, w) + b.float().view(1, -1, 1, 1)
        return rnd(torch.maximum(y, y * LEAKY))

    (w6, b6), (w7, b7), (w9, b9), (w10, b10) = fwd
    with _cuda.no_tf32():
        x = _body(xp, w_img)
        a = layer(x, w6, b6)
        post7 = layer(a, w7, b7)
        y8 = rnd(post7 + x)
        c = layer(y8, w9, b9)
        post10 = layer(c, w10, b10)
        y11 = _planar((post10 + y8).to(dt))
    if not save:
        return y11
    return (y11, *[_planar((v > 0).to(torch.int8))
                   for v in (a, post7, c, post10)])


def res152_fused_grad_plain(g11p: torch.Tensor, masks, bwd: ResBwd,
                            w_img=None) -> torch.Tensor:
    """K6b's plain version, in ``_stage_chain``'s order and roundings:
    (g11 planar, the masks (am, p7m, cm, p10m)) -> planar g5."""
    dt = g11p.dtype
    w_img = w_img if w_img is not None else g11p.shape[1]
    am, p7m, cm, p10m = (_body(m, w_img) for m in masks)
    w6t, w7t, w9t, w10t = bwd

    def rnd(v):
        return v.to(dt).float()

    def gate(m):
        return torch.where(m > 0, 1.0, LEAKY)

    with _cuda.no_tf32():
        g11 = _body(g11p, w_img)
        gp10 = rnd(g11 * gate(p10m))
        gp9 = rnd(_conv(gp10, w10t) * gate(cm))
        g8 = rnd(_conv(gp9, w9t) + g11)
        gp7 = rnd(g8 * gate(p7m))
        gp6 = rnd(_conv(gp7, w7t) * gate(am))
        g5 = (_conv(gp6, w6t) + g8).to(dt)
    return _planar(g5)


def _check_weights(name, ws, shapes, dt, device):
    """The kernels read the weights as they are: contiguous HWIO of the
    stage's shapes, in the compute dtype, on the input's device."""
    for w, shape in zip(ws, shapes):
        if (tuple(w.shape) != shape or w.dtype != dt or w.device != device
                or not w.is_contiguous()):
            raise ValueError(f"{name}: weight {tuple(w.shape)} {w.dtype} on "
                             f"{w.device}, expected contiguous {shape} {dt} "
                             f"on {device}")


def _check_stage(name, xp, w_img):
    b, h, c, wl = xp.shape
    if c != CIN or wl != _round_up(w_img + 2, 128):
        raise ValueError(f"{name}: planar {tuple(xp.shape)} for w_img="
                         f"{w_img}, expected [B, H, {CIN}, "
                         f"{_round_up(w_img + 2, 128)}]")


def res152_fused(xp: torch.Tensor, fwd: ResFwd, *, save: bool = False,
                 w_img=None):
    """Planar [B, H, 128, Wl] -> planar y11 of the same shape (layers
    6-11); with ``save`` the tuple (y11, am, p7m, cm, p10m), the masks
    int8 [B, H, 64 | 128 | 64 | 128, Wl]. ``fwd`` is ``res_weights``'s
    first half; ``w_img`` defaults to H. The two instantiations count
    their own launches: ``res152_fused.launches`` and
    ``res152_fused.save_launches``."""
    if xp.device.type == "cpu":
        return res152_fused_plain(xp, fwd, save, w_img)
    _cuda.require_cuda("res152_fused", xp)
    dt = xp.dtype
    bsz, h, _, wl = xp.shape
    w_img = w_img if w_img is not None else h
    _check_stage("res152_fused", xp, w_img)
    _check_weights("res152_fused", [w for w, _ in fwd], FWD_SHAPES, dt,
                   xp.device)
    for (_, bias), shape in zip(fwd, FWD_SHAPES):
        if (tuple(bias.shape) != (shape[-1],) or bias.dtype != torch.float32
                or bias.device != xp.device or not bias.is_contiguous()):
            raise ValueError(f"res152_fused: bias {tuple(bias.shape)} "
                             f"{bias.dtype} on {bias.device}")
    # the kernel writes every lane, borders and padding included
    y11 = torch.empty_like(xp)
    masks = []
    if save:
        masks = [torch.empty((bsz, h, c, wl), dtype=torch.int8,
                             device=xp.device)
                 for c in (MID, CIN, MID, CIN)]
    mask_ptrs = [m.data_ptr() for m in masks] or [None] * 4
    err = _cuda.lib("res_fused").apfp_res152_fused(
        xp.data_ptr(), *[w.data_ptr() for w, _ in fwd],
        *[bias.data_ptr() for _, bias in fwd], y11.data_ptr(), *mask_ptrs,
        _cuda.DTYPE_CODES[dt], bsz, h, w_img, wl, _cuda.stream_ptr(xp))
    _cuda.check(err, "res152_fused")
    if save:
        res152_fused.save_launches += 1
        return (y11, *masks)
    res152_fused.launches += 1
    return y11


res152_fused.launches = 0
res152_fused.save_launches = 0


def res152_fused_grad(g11p: torch.Tensor, masks, bwd: ResBwd, *,
                      w_img=None) -> torch.Tensor:
    """Saved-mask input cotangent: (g11 planar [B, H, 128, Wl], the masks
    of ``res152_fused(save=True)``) -> planar g5 of g11's shape. ``bwd``
    is ``res_weights``'s second half."""
    if g11p.device.type == "cpu":
        return res152_fused_grad_plain(g11p, masks, bwd, w_img)
    _cuda.require_cuda("res152_fused_grad", g11p)
    _cuda.require_cuda_int8("res152_fused_grad", g11p.device, *masks)
    dt = g11p.dtype
    bsz, h, _, wl = g11p.shape
    w_img = w_img if w_img is not None else h
    _check_stage("res152_fused_grad", g11p, w_img)
    want = [(bsz, h, c, wl) for c in (MID, CIN, MID, CIN)]
    if len(masks) != 4 or [tuple(m.shape) for m in masks] != want:
        raise ValueError(f"res152_fused_grad: masks "
                         f"{[tuple(m.shape) for m in masks]}, expected "
                         f"{want}")
    _check_weights("res152_fused_grad", bwd, BWD_SHAPES, dt, g11p.device)
    g5 = torch.empty_like(g11p)
    err = _cuda.lib("res_fused").apfp_res152_fused_grad(
        g11p.data_ptr(), *[m.data_ptr() for m in masks],
        *[w.data_ptr() for w in bwd], g5.data_ptr(), _cuda.DTYPE_CODES[dt],
        bsz, h, w_img, wl, _cuda.stream_ptr(g11p))
    _cuda.check(err, "res152_fused_grad")
    res152_fused_grad.launches += 1
    return g5


res152_fused_grad.launches = 0
