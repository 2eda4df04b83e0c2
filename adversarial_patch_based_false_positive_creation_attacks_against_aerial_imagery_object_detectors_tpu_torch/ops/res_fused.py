"""The 152^2 residual stage (YOLOv3 layers 6-11: conv 1x1 128->64, conv
3x3 64->128, shortcut, twice) in one kernel each way: K6a forward
(``res152_fused``) and K6b saved-mask input backward
(``res152_fused_grad``), the JAX package's Pallas ``ops/res_fused.py``;
and K6c (``res152_fused_grad12``), K6b widened by conv12's stride-2 input
cotangent, which it computes from conv12's pre-gated cotangent before the
stage's chain.

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
ported). In bfloat16 the kernels run on ``wgmma`` and read each of those
weights packed into the 64-deep swizzled chunks their producer warp
streams into shared memory (``stage_packed``: ``wg_weights_conv``, taps in
row-major order, W9's adjoint in halves of 64 output channels; K6c's ``res12_weights`` by output parity,
``conv12_packed``: ``wg_weights_t2``), built once per weight tensor by
``_mma_cached``; float32 reads the HWIO weights alone.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .planar_conv import _mma_cached, _round_up, flip_t, to_planar_plain
from .stem_fused import wg_weights_conv, wg_weights_t2

CIN = 128      # stage width (yolov3); MID = CIN // 2
MID = CIN // 2
LEAKY = 0.1

# (forward HWIO shapes of w6, w7, w9, w10), (backward: w6t, w7t, w9t, w10t)
FWD_SHAPES = ((1, 1, CIN, MID), (3, 3, MID, CIN), (1, 1, CIN, MID),
              (3, 3, MID, CIN))
BWD_SHAPES = ((1, 1, MID, CIN), (3, 3, CIN, MID), (1, 1, MID, CIN),
              (3, 3, CIN, MID))
# K6c's conv12 weight: HWIO [3, 3, 128, 256] with its channel axes swapped
W12T_SHAPE = (3, 3, 2 * CIN, CIN)

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


def res12_weights(w12: torch.Tensor) -> torch.Tensor:
    """K6c's conv12 weight from conv12's HWIO kernel [3, 3, 128, 256] (the
    compute dtype, BN-folded): its two channel axes swapped,
    [3, 3, 256, 128] contiguous, so each tap's [cin][cout] block is the
    adjoint's. Built once by the model. (The JAX package's
    ``res12_weights`` also builds a parity pair matrix: TPU blocking, not
    ported; the kernel splits the taps by parity itself.)"""
    return w12.permute(0, 1, 3, 2).contiguous()


def wg_weights_halves(w: torch.Tensor) -> torch.Tensor:
    """A 1x1 64 -> 128 adjoint's ``[1, 1, K, N]`` weights (W9's, over the
    10 x 18 halo) as the bfloat16 K6b runs it: two GEMMs of N/2 output
    channels (``wg_weights_conv`` of each half), back to back."""
    half = w.shape[-1] // 2
    return torch.cat([wg_weights_conv(w[..., :half].contiguous()),
                      wg_weights_conv(w[..., half:].contiguous())])


# how the bfloat16 kernels run each of the stage's weights: the forward's
# W6, W7, W9, W10 and the backward's W6^T, W7^T, W10^T one GEMM each, W9^T
# in two halves
FWD_BUILDS = (wg_weights_conv,) * 4
BWD_BUILDS = (wg_weights_conv, wg_weights_conv, wg_weights_halves,
              wg_weights_conv)


def stage_packed(ws, builds, dt) -> list:
    """The bfloat16 kernels' ``wgmma`` copies of the stage's HWIO weights
    ``ws`` (the forward's convs or their ``flip_t`` adjoints) packed by
    ``builds`` (``FWD_BUILDS``, ``BWD_BUILDS``: each GEMM's taps in
    row-major order), built once per weight tensor, as pointers; null
    pointers in float32, whose kernels read ``ws``."""
    if dt != torch.bfloat16:
        return [None] * len(ws)
    return [_mma_cached(w, build).data_ptr() for w, build in zip(ws, builds)]


def conv12_packed(w12t: torch.Tensor, dt):
    """K6c's conv12^T (``res12_weights``) as its prologue's four parity
    GEMMs run it (``wg_weights_t2``: each output parity's taps in
    ``RowsT2``'s order, the four back to back), built once per weight
    tensor, as a pointer; null in float32."""
    if dt != torch.bfloat16:
        return None
    return _mma_cached(w12t, wg_weights_t2).data_ptr()


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
    _cuda.launch(
        "res152_fused", "res_fused", "apfp_res152_fused", xp,
        xp.data_ptr(), *[w.data_ptr() for w, _ in fwd],
        *[bias.data_ptr() for _, bias in fwd],
        *stage_packed([w for w, _ in fwd], FWD_BUILDS, dt), y11.data_ptr(),
        *mask_ptrs,
        _cuda.DTYPE_CODES[dt], bsz, h, w_img, wl)
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
    _cuda.launch(
        "res152_fused_grad", "res_fused", "apfp_res152_fused_grad", g11p,
        g11p.data_ptr(), *[m.data_ptr() for m in masks],
        *[w.data_ptr() for w in bwd], *stage_packed(bwd, BWD_BUILDS, dt),
        g5.data_ptr(),
        _cuda.DTYPE_CODES[dt], bsz, h, w_img, wl)
    res152_fused_grad.launches += 1
    return g5


res152_fused_grad.launches = 0


def res152_fused_grad12_plain(gp12p: torch.Tensor, masks, bwd: ResBwd,
                              w12t: torch.Tensor, w_img=None) -> torch.Tensor:
    """K6c's plain version: g11 = T(conv12^T gp12) (``F.conv_transpose2d``
    with stride 2, padding 1, output_padding 1, float32; stored in the
    compute dtype once, as ``_bwd12_kernel`` stores it: its one-hot lane
    interleave is exact), zero outside the image, then
    ``res152_fused_grad_plain``. gp12p: the pre-gated conv12 cotangent,
    planar [B, H/2, 256, Wl12]."""
    dt = gp12p.dtype
    w_img = w_img if w_img is not None else 2 * gp12p.shape[1]
    # conv_transpose2d's weight [cin, cout, kh, kw] is the forward conv's
    # OIHW: conv12's [256, 128, 3, 3]
    w12 = w12t.permute(2, 3, 0, 1).float()
    with _cuda.no_tf32():
        g11 = F.conv_transpose2d(_body(gp12p, w_img // 2), w12, stride=2,
                                 padding=1, output_padding=1).to(dt)
    return res152_fused_grad_plain(_planar(g11), masks, bwd, w_img)


def res152_fused_grad12(gp12p: torch.Tensor, masks, bwd: ResBwd,
                        w12t: torch.Tensor, *, w_img=None) -> torch.Tensor:
    """The conv12-widened saved-mask input cotangent: (gp12 planar
    [B, H/2, 256, Wl12], the masks of ``res152_fused(save=True)``) ->
    planar g5 [B, H, 128, Wl] (H and the image width even). conv12's
    stride-2 dgrad runs inside the kernel. ``bwd``: ``res_weights``'s
    second half; ``w12t``: ``res12_weights``'s. Counted in
    ``res152_fused_grad12.launches``."""
    if gp12p.device.type == "cpu":
        return res152_fused_grad12_plain(gp12p, masks, bwd, w12t, w_img)
    _cuda.require_cuda("res152_fused_grad12", gp12p)
    _cuda.require_cuda_int8("res152_fused_grad12", gp12p.device, *masks)
    dt = gp12p.dtype
    bsz, h12, c12, wl12 = gp12p.shape
    h = 2 * h12
    w_img = w_img if w_img is not None else h
    wl = _round_up(w_img + 2, 128)
    if (c12 != 2 * CIN or w_img % 2
            or wl12 != _round_up(w_img // 2 + 2, 128)):
        raise ValueError(f"res152_fused_grad12: gp12 {tuple(gp12p.shape)} "
                         f"for w_img={w_img}, expected [B, H/2, {2 * CIN}, "
                         f"{_round_up(w_img // 2 + 2, 128)}]")
    want = [(bsz, h, c, wl) for c in (MID, CIN, MID, CIN)]
    if len(masks) != 4 or [tuple(m.shape) for m in masks] != want:
        raise ValueError(f"res152_fused_grad12: masks "
                         f"{[tuple(m.shape) for m in masks]}, expected "
                         f"{want}")
    _check_weights("res152_fused_grad12", [*bwd, w12t],
                   [*BWD_SHAPES, W12T_SHAPE], dt, gp12p.device)
    # the kernel writes every lane, borders and padding included
    g5 = torch.empty((bsz, h, CIN, wl), dtype=dt, device=gp12p.device)
    _cuda.launch(
        "res152_fused_grad12", "res_fused", "apfp_res152_fused_grad12",
        gp12p, gp12p.data_ptr(), *[m.data_ptr() for m in masks],
        w12t.data_ptr(), *[w.data_ptr() for w in bwd],
        conv12_packed(w12t, dt), *stage_packed(bwd, BWD_BUILDS, dt),
        g5.data_ptr(),
        _cuda.DTYPE_CODES[dt], bsz, h, w_img, wl, wl12)
    res152_fused_grad12.launches += 1
    return g5


res152_fused_grad12.launches = 0
