"""The fused YOLOv3 stem: layers 0-5 forward (K1) and input backward from
saved masks (K2) or from recomputed ones (K5).

``fused_stem_fwd`` takes the even/odd column phases of the input in the
planar layout (``split_phases``) and returns y5 planar
``[B, H/4, 128, Wl5]``, exactly as the JAX package's Pallas
``ops/stem_fused.py: fused_stem_fwd`` does; with ``save_acts=True`` it
also returns the int8 sign masks of y0 (both column phases), y1, y2 and
y3 that the backward needs. ``fused_stem_bwd_saved`` (K2) turns those
masks, y5 and a planar cotangent g5 into the phase-split planar input
cotangent, as the Pallas ``fused_stem_bwd_saved`` does;
``fused_stem_bwd`` (K5) does the same from x, y5 and g5 alone,
recomputing the masks on chip, as the Pallas ``fused_stem_bwd`` does. On
a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/stem_fused.cu``, ``csrc/stem_bwd.cu``, ``csrc/stem_remat.cu``);
on a CPU tensor it runs its plain version, the same function as
``F.conv2d`` / ``F.conv_transpose2d`` chains with the kernel's rounding
points (float32 accumulation; the compute dtype where the Pallas kernel
stores). The kernels are bound by operations on the H100 (11.2 GFLOP per
608^2 image each way); see the sources. In bfloat16, K1, K2 and K5 run
their convs on ``wgmma`` with the weights streamed into shared memory by
bulk copies, packed on the host in the descriptor's swizzled chunks
(``wg_weights``; ``k1_packed`` and ``k2_packed``, built once per weight
tensor). K5 runs K1's GEMMs on K1's packing to recompute the masks and
K2's chain on K2's, so in either dtype its result equals K2's on K1's
masks bit for bit.

Three autograd Functions around them, the JAX package's three custom
VJPs of the stem; each returns the input cotangent only (the victim's
weights are frozen):

- ``fused_stem`` / ``FusedStem``: NHWC in, NHWC out: ``split_phases``
  (K3a, both phases in one launch) -> K1 (``save_acts``) ->
  ``from_planar`` (K3b); backward K3a (g5 -> planar) -> K2 ->
  ``merge_phases``.
- ``fused_stem_remat`` / ``FusedStemRemat``: the same forward without
  masks, saving only x's phases and y5; backward K3a -> K5.
- ``fused_stem_planar`` / ``FusedStemPlanar``: stops at the planar y5
  (no K3b) and takes a planar g5 back (no K3a): the conv12-widened
  stage's handoff (``models/res_planar.res152_c12_fused``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .planar_conv import (_mma_cached, _round_up, from_planar,
                          from_planar_plain, mma_weights, to_planar,
                          to_planar_phases, to_planar_plain, wg_weights)

LEAKY = 0.1

STEM_FILTERS = (32, 64, 32, 64, 128)
STEM_IN = (3, 32, 64, 32, 64)
STEM_KSIZE = (3, 3, 1, 3, 3)
# K2's weights per conv: HWIO with the channel axes swapped,
# [kh, kw, cout, cin]; conv0's cin padded 3 -> 8
STEM_BWD_SHAPES = ((3, 3, 32, 8), (3, 3, 64, 32), (1, 1, 32, 64),
                   (3, 3, 64, 32), (3, 3, 128, 64))

StemParams = Sequence[Tuple[torch.Tensor, torch.Tensor]]
StemBwdParams = Sequence[torch.Tensor]


def split_phases(x: torch.Tensor):
    """NHWC [B, H, W, C<=8] -> (even-column, odd-column) planar phases,
    each [B, H, 8, round_up(W/2+2, 128)] with value j at lane j+1: one
    K3a launch on a CUDA tensor (``to_planar_phases``)."""
    return to_planar_phases(x, c_pad=8)


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


def stem_bwd_params(sp: StemParams) -> list:
    """K2's weights from the forward's HWIO weights: each with its channel
    axes swapped (``[kh, kw, cout, cin]``, contiguous, the compute dtype),
    conv0's padded from 3 to 8 input channels with zeros."""
    out = []
    for w, _ in sp:
        v = w.permute(0, 1, 3, 2)
        if v.shape[-1] < 8:
            v = F.pad(v, (0, 8 - v.shape[-1]))
        out.append(v.contiguous())
    return out


# ---------------------------------------------------------------------------
# Weights packed for the wgmma kernels (the bfloat16 K1 and K2)
# ---------------------------------------------------------------------------

def wg_weights_conv(w: torch.Tensor) -> torch.Tensor:
    """A conv's (or a stride-1 adjoint's) ``[kh, kw, K, N]`` weights, taps
    in row-major order (``RowsConv``, ``RowsT1``), packed by
    ``wg_weights``."""
    kh, kw, k, n = w.shape
    return wg_weights(w.reshape(kh * kw, k, n))


def wg_weights_conv0(w: torch.Tensor) -> torch.Tensor:
    """conv0's HWIO ``[3, 3, 3, 32]`` as K1's conv0 steps through it
    (``RowsConv0``): channels padded 3 -> 8 and a zero fourth column, each
    16-deep step the taps kx = 2 pair, 2 pair + 1 of one row (6 steps),
    packed by ``wg_weights``."""
    kh, kw, cin, cout = w.shape
    v = F.pad(w, (0, 0, 0, 8 - cin, 0, 4 - kw))
    return wg_weights(v.reshape(kh * 2, 16, cout))


# the four output parities (py, px) of a stride-2 adjoint and their taps
# (dy, dx) in the kernel's order (stem_common.cuh: RowsT2)
T2_PARITY_TAPS = tuple(
    tuple(((2 * (i // (px + 1)) if py else 1, 2 * (i % (px + 1)) if px else 1)
           for i in range((py + 1) * (px + 1))))
    for py in (0, 1) for px in (0, 1))


def wg_weights_t2(v: torch.Tensor) -> torch.Tensor:
    """A stride-2 adjoint's ``[3, 3, K, N]`` weights (``stem_bwd_params``:
    conv1's or conv5's) as K2 runs it, one GEMM per output parity: each
    parity's taps (``T2_PARITY_TAPS``) packed by ``wg_weights``, the four
    back to back."""
    return torch.cat([wg_weights(torch.stack([v[dy, dx] for dy, dx in taps]))
                      for taps in T2_PARITY_TAPS])


def k1_packed(sp: StemParams, n: int = 5) -> list:
    """The data pointers of K1's convs 0, 1, 2, 3, 5 (the first ``n``)
    packed for ``wgmma`` (``wg_weights_conv0``, ``wg_weights_conv``),
    each built once per weight tensor: the bfloat16 K1 reads all five, K5's
    recompute convs 0-3."""
    builds = (wg_weights_conv0,) + (wg_weights_conv,) * 4
    return [_mma_cached(w, build).data_ptr()
            for (w, _), build in zip(sp[:n], builds)]


# K2's adjoints as its wgmma chain runs them: conv1^T and conv5^T per
# output parity
K2_BUILDS = (wg_weights_conv, wg_weights_t2, wg_weights_conv,
             wg_weights_conv, wg_weights_t2)


def k2_packed(sbp: StemBwdParams) -> list:
    """The data pointers of K2's five swapped-channel adjoints packed for
    its ``wgmma`` chain (``K2_BUILDS``), each built once per weight tensor:
    the chain K2, K5 and K8b share reads them."""
    return [_mma_cached(v, build).data_ptr()
            for v, build in zip(sbp, K2_BUILDS)]


def wgmma_bitcheck(a: torch.Tensor, b: torch.Tensor):
    """``a`` [64, K] and ``b`` [K, 64] bfloat16 on a card (K a multiple of
    64, at most 768) -> ``(d_mma, d_wgmma)``, each [64, 64] float32: the
    product ``a @ b`` summed one 16-deep step after another from zero by
    ``mma.sync.m16n8k16`` and by ``wgmma.m64n64k16`` (A from the same
    ``ldmatrix`` registers), in one launch of a check kernel
    (``csrc/stem_fused.cu: wgmma_bitcheck_kernel``). Equal bits say that
    a ``wgmma`` k16 step sums as an ``mma.sync`` one: the ``wgmma`` kernels
    equal the ``mma.sync`` ones they replaced, bit for bit."""
    _cuda.require_cuda("wgmma_bitcheck", a, b)
    k = a.shape[1]
    if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or tuple(a.shape) != (64, k) or tuple(b.shape) != (k, 64)
            or k % 64 or k > 768):
        raise ValueError(f"wgmma_bitcheck: a {tuple(a.shape)} {a.dtype}, "
                         f"b {tuple(b.shape)} {b.dtype}")
    frags = mma_weights(b.reshape(1, 1, k, 64))
    packed = wg_weights(b[None])
    dm = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    dw = torch.empty_like(dm)
    _cuda.launch("wgmma_bitcheck", "stem_fused", "apfp_wgmma_bitcheck", a,
                 a.data_ptr(), frags.data_ptr(), packed.data_ptr(),
                 dm.data_ptr(), dw.data_ptr(), k)
    torch.cuda.synchronize(a.device)
    return dm, dw


def _sign_mask(v: torch.Tensor) -> torch.Tensor:
    return (v > 0).to(torch.int8)


def fused_stem_fwd_plain(xe: torch.Tensor, xo: torch.Tensor,
                         sp: StemParams, save_acts: bool = False):
    """K1's plain version: phase-split planar x -> planar y5. ``sp`` holds
    (HWIO weight in the compute dtype, float32 bias) for convs 0,1,2,3,5
    (``models/stem_planar._stem_params``). ``save_acts`` also returns
    the int8 sign masks ``(y5, y0e, y0o, y1, y2, y3)``, planar as the
    Pallas kernel's: y0's even/odd column phases [B, H, 32, Wlh], y1 and
    y3 [B, H/2, 64, Wlh], y2 [B, H/2, 32, Wlh]; the sign is that of the
    value rounded to the compute dtype, and y3's is taken before the
    shortcut sum."""
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
    y5p = to_planar_plain(y5.permute(0, 2, 3, 1))
    if not save_acts:
        return y5p
    m0 = _sign_mask(y0).permute(0, 2, 3, 1)
    return (y5p, to_planar_plain(m0, step=2, offset=0),
            to_planar_plain(m0, step=2, offset=1),
            *[to_planar_plain(_sign_mask(y).permute(0, 2, 3, 1))
              for y in (y1, y2, y3)])


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


def _check_stem_bwd_params(sbp: StemBwdParams, dt: torch.dtype,
                           device: torch.device) -> None:
    """K2 reads ``sbp`` as it is: contiguous ``stem_bwd_params`` weights
    in the compute dtype, on the input's device."""
    if len(sbp) != 5:
        raise ValueError("fused_stem_bwd_saved: expected 5 weights")
    for v, shape in zip(sbp, STEM_BWD_SHAPES):
        if (tuple(v.shape) != shape or v.dtype != dt or v.device != device
                or not v.is_contiguous()):
            raise ValueError(
                f"fused_stem_bwd_saved: weight {tuple(v.shape)} {v.dtype} "
                f"on {v.device}, expected contiguous {shape} {dt} on "
                f"{device}")


def fused_stem_fwd(xe: torch.Tensor, xo: torch.Tensor, sp: StemParams,
                   save_acts: bool = False):
    """Phase-split planar x [B, H, 8, Wlh] -> planar y5
    [B, H/4, 128, Wl5] (square images, H % 4 == 0); with ``save_acts``
    the tuple ``(y5, y0e, y0o, y1, y2, y3)`` of ``fused_stem_fwd_plain``.
    The two instantiations count their own launches:
    ``fused_stem_fwd.launches`` and ``fused_stem_fwd.save_acts_launches``."""
    if xe.device.type == "cpu":
        return fused_stem_fwd_plain(xe, xo, sp, save_acts)
    _cuda.require_cuda("fused_stem_fwd", xe, xo)
    bsz, h, cp, wlh = xe.shape
    dt = xe.dtype
    if (xo.shape != xe.shape or xo.dtype != dt or cp != 8 or h % 4
            or wlh != _round_up(h // 2 + 2, 128)):
        raise ValueError(f"fused_stem_fwd: bad phase geometry {xe.shape}")
    _check_stem_params(sp, dt, xe.device)
    h1, h5 = h // 2, h // 4
    wl5 = _round_up(h5 + 2, 128)
    # the kernel writes every lane, borders and padding included
    y5 = torch.empty((bsz, h5, 128, wl5), dtype=dt, device=xe.device)
    masks = []
    if save_acts:
        masks = [torch.empty((bsz, rows, c, wlh), dtype=torch.int8,
                             device=xe.device)
                 for rows, c in ((h, 32), (h, 32), (h1, 64), (h1, 32),
                                 (h1, 64))]
    mask_ptrs = [m.data_ptr() for m in masks] or [None] * 5
    # bfloat16 on wgmma (packed chunks), float32 on sp
    packed = k1_packed(sp) if dt == torch.bfloat16 else [None] * 5
    _cuda.launch(
        "fused_stem_fwd", "stem_fused", "apfp_fused_stem_fwd", xe,
        xe.data_ptr(), xo.data_ptr(), *[w.data_ptr() for w, _ in sp],
        *[bias.data_ptr() for _, bias in sp], *packed, y5.data_ptr(),
        *mask_ptrs, _cuda.DTYPE_CODES[dt], bsz, h, wlh, wl5)
    if save_acts:
        fused_stem_fwd.save_acts_launches += 1
        return (y5, *masks)
    fused_stem_fwd.launches += 1
    return y5


fused_stem_fwd.launches = 0
fused_stem_fwd.save_acts_launches = 0


def fused_stem_bwd_saved_plain(acts, g5p: torch.Tensor,
                               sbp: StemBwdParams):
    """K2's plain version: ``(y5, y0e, y0o, y1, y2, y3)`` of
    ``fused_stem_fwd(..., save_acts=True)`` and a planar cotangent g5
    [B, H/4, 128, Wl5] (y5's dtype) -> the phase-split planar input
    cotangent (gxe, gxo), each [B, H, 8, Wlh]. ``F.conv_transpose2d``
    chains in float32 that round to the compute dtype where the Pallas
    ``_grad_chain`` stores, gated by the same masks."""
    y5p, y0e, y0o, y1m, y2m, y3m = acts
    dt = y5p.dtype
    h = y0e.shape[1]
    h1, h5 = h // 2, h // 4

    def nchw(p, w, c):
        return from_planar_plain(p, w, c).permute(0, 3, 1, 2)

    def gate(m):
        return torch.where(m > 0, 1.0, LEAKY)

    def rnd(v):
        return v.to(dt).float()

    # [cout, cin, kh, kw]: conv_transpose2d's weight is the forward's
    wt = [v.permute(2, 3, 0, 1).float() for v in sbp]
    with _cuda.no_tf32():
        gp5 = rnd(nchw(g5p, h5, 128).float()
                  * gate(nchw(y5p, h5, 128).float()))
        gs4 = rnd(F.conv_transpose2d(gp5, wt[4], stride=2, padding=1,
                                     output_padding=1))
        gp3 = rnd(gs4 * gate(nchw(y3m, h1, 64)))
        gp2 = rnd(F.conv_transpose2d(gp3, wt[3], padding=1)
                  * gate(nchw(y2m, h1, 32)))
        gp1 = rnd((F.conv_transpose2d(gp2, wt[2]) + gs4)
                  * gate(nchw(y1m, h1, 64)))
        m0 = merge_phases(y0e, y0o, h1, 32).permute(0, 3, 1, 2)
        gp0 = rnd(F.conv_transpose2d(gp1, wt[1], stride=2, padding=1,
                                     output_padding=1) * gate(m0))
        gx = F.conv_transpose2d(gp0, wt[0], padding=1).to(dt)
    gx = gx.permute(0, 2, 3, 1)
    return (to_planar_plain(gx, 8, 2, 0), to_planar_plain(gx, 8, 2, 1))


def fused_stem_bwd_saved(acts, g5p: torch.Tensor, sbp: StemBwdParams):
    """``fused_stem_bwd_saved_plain`` as the K2 kernel on CUDA tensors
    (H % 16 == 0)."""
    y5p, y0e, y0o, y1m, y2m, y3m = acts
    if y5p.device.type == "cpu":
        return fused_stem_bwd_saved_plain(acts, g5p, sbp)
    _cuda.require_cuda("fused_stem_bwd_saved", y5p, g5p)
    _cuda.require_cuda_int8("fused_stem_bwd_saved", y5p.device, y0e, y0o,
                            y1m, y2m, y3m)
    dt = y5p.dtype
    bsz, h, _, wlh = y0e.shape
    h1, h5 = h // 2, h // 4
    wl5 = _round_up(h5 + 2, 128)
    want = {"y5": (y5p, (bsz, h5, 128, wl5)), "g5": (g5p, (bsz, h5, 128,
                                                           wl5)),
            "y0e": (y0e, (bsz, h, 32, wlh)), "y0o": (y0o, (bsz, h, 32, wlh)),
            "y1": (y1m, (bsz, h1, 64, wlh)), "y2": (y2m, (bsz, h1, 32, wlh)),
            "y3": (y3m, (bsz, h1, 64, wlh))}
    bad = [k for k, (t, s) in want.items() if tuple(t.shape) != s]
    if (bad or g5p.dtype != dt or h % 16
            or wlh != _round_up(h1 + 2, 128)):
        raise ValueError(f"fused_stem_bwd_saved: bad geometry {bad} for "
                         f"y0e {tuple(y0e.shape)}, or g5 {g5p.dtype} vs "
                         f"y5 {dt}")
    _check_stem_bwd_params(sbp, dt, y5p.device)
    # the kernel writes every lane, borders and padding included
    gxe = torch.empty((bsz, h, 8, wlh), dtype=dt, device=y5p.device)
    gxo = torch.empty_like(gxe)
    # bfloat16 on wgmma (packed chunks; conv1^T and conv5^T per output
    # parity), float32 on sbp
    packed = k2_packed(sbp) if dt == torch.bfloat16 else [None] * 5
    _cuda.launch(
        "fused_stem_bwd_saved", "stem_bwd", "apfp_fused_stem_bwd", y5p,
        y0e.data_ptr(), y0o.data_ptr(), y1m.data_ptr(), y2m.data_ptr(),
        y3m.data_ptr(), y5p.data_ptr(), g5p.data_ptr(),
        *[v.data_ptr() for v in sbp], *packed, gxe.data_ptr(),
        gxo.data_ptr(), _cuda.DTYPE_CODES[dt], bsz, h, wlh, wl5)
    fused_stem_bwd_saved.launches += 1
    return gxe, gxo


fused_stem_bwd_saved.launches = 0


def fused_stem_bwd_plain(xe: torch.Tensor, xo: torch.Tensor,
                         y5p: torch.Tensor, g5p: torch.Tensor,
                         sp: StemParams, sbp: StemBwdParams):
    """K5's plain version: the masks recomputed by K1's plain forward with
    ``save_acts`` from the phase-split x, then K2's plain chain on them
    with gp5 gated by the *given* y5 (as the Pallas ``_grad_chain`` gates
    by its y5 input). The same function as the Pallas remat
    ``_bwd_kernel``, whose recompute rounds where K1 stores."""
    acts = fused_stem_fwd_plain(xe, xo, sp, save_acts=True)
    return fused_stem_bwd_saved_plain((y5p, *acts[1:]), g5p, sbp)


def fused_stem_bwd(xe: torch.Tensor, xo: torch.Tensor, y5p: torch.Tensor,
                   g5p: torch.Tensor, sp: StemParams, sbp: StemBwdParams):
    """Phase-split planar x [B, H, 8, Wlh], planar y5 and g5
    [B, H/4, 128, Wl5] -> the phase-split planar input cotangent (gxe,
    gxo), recomputing the stem's masks instead of reading saved ones
    (H % 16 == 0): ``fused_stem_bwd_plain`` as the K5 kernel on CUDA
    tensors, counted in ``fused_stem_bwd.launches``. ``sp``: K1's
    weights (convs 0-3 are read); ``sbp``: K2's."""
    if xe.device.type == "cpu":
        return fused_stem_bwd_plain(xe, xo, y5p, g5p, sp, sbp)
    _cuda.require_cuda("fused_stem_bwd", xe, xo, y5p, g5p)
    bsz, h, cp, wlh = xe.shape
    dt = xe.dtype
    h5 = h // 4
    wl5 = _round_up(h5 + 2, 128)
    if (xo.shape != xe.shape or cp != 8 or h % 16
            or wlh != _round_up(h // 2 + 2, 128)
            or any(t.dtype != dt for t in (xo, y5p, g5p))
            or tuple(y5p.shape) != (bsz, h5, 128, wl5)
            or g5p.shape != y5p.shape):
        raise ValueError(f"fused_stem_bwd: bad geometry x {tuple(xe.shape)} "
                         f"y5 {tuple(y5p.shape)} g5 {tuple(g5p.shape)} or "
                         f"dtypes")
    _check_stem_params(sp, dt, xe.device)
    _check_stem_bwd_params(sbp, dt, xe.device)
    # the kernel writes every lane, borders and padding included
    gxe = torch.empty((bsz, h, 8, wlh), dtype=dt, device=xe.device)
    gxo = torch.empty_like(gxe)
    # bfloat16 on wgmma: K1's packed convs 0-3 (the recompute) and K2's
    # packed adjoints (the chain); float32 on sp and sbp
    packed = (k1_packed(sp, 4) + k2_packed(sbp)
              if dt == torch.bfloat16 else [None] * 9)
    _cuda.launch(
        "fused_stem_bwd", "stem_remat", "apfp_fused_stem_remat", xe,
        xe.data_ptr(), xo.data_ptr(), *[w.data_ptr() for w, _ in sp[:4]],
        *[bias.data_ptr() for _, bias in sp[:4]], y5p.data_ptr(),
        g5p.data_ptr(), *[v.data_ptr() for v in sbp], *packed,
        gxe.data_ptr(), gxo.data_ptr(), _cuda.DTYPE_CODES[dt], bsz, h, wlh,
        wl5)
    fused_stem_bwd.launches += 1
    return gxe, gxo


fused_stem_bwd.launches = 0


def _needs_grad(x: torch.Tensor, sbp, name: str) -> bool:
    if not (x.requires_grad and torch.is_grad_enabled()):
        return False
    if sbp is None:
        raise ValueError(f"{name}: an input that requires grad needs the "
                         f"backward weights (sbp)")
    return True


class FusedStem(torch.autograd.Function):
    """The stem with its saved-sign backward: forward split_phases -> K1
    (save_acts) -> K3b; backward K3a (g5 in the compute dtype) -> K2 ->
    merge_phases. Only the input cotangent is returned (the JAX
    package's ``fused_stem`` custom VJP returns zeros for the weights)."""

    @staticmethod
    def forward(ctx, x, sp, sbp):
        xe, xo = split_phases(x)
        acts = fused_stem_fwd(xe, xo, sp, save_acts=True)
        ctx.save_for_backward(*acts)
        ctx.sbp = sbp
        return from_planar(acts[0], x.shape[1] // 4, 128)

    @staticmethod
    def backward(ctx, g5):
        acts = ctx.saved_tensors
        h = acts[1].shape[1]
        g5p = to_planar(g5.to(acts[0].dtype).contiguous())
        gxe, gxo = fused_stem_bwd_saved(acts, g5p, ctx.sbp)
        return merge_phases(gxe, gxo, h // 2, 3), None, None


def fused_stem(x: torch.Tensor, sp: StemParams,
               sbp: StemBwdParams = None) -> torch.Tensor:
    """NHWC [B, H, W, 3] (compute dtype) -> NHWC [B, H/4, W/4, 128]:
    split_phases -> fused_stem_fwd -> from_planar. Where autograd records
    (``x.requires_grad``), ``FusedStem`` with K2's weights ``sbp``
    (``stem_bwd_params``, built once by the model); otherwise forward
    only, saving no masks."""
    if _needs_grad(x, sbp, "fused_stem"):
        return FusedStem.apply(x, sp, sbp)
    xe, xo = split_phases(x)
    y5p = fused_stem_fwd(xe, xo, sp)
    return from_planar(y5p, x.shape[1] // 4, 128)


class FusedStemRemat(torch.autograd.Function):
    """The stem with the recomputing backward (the JAX package's
    ``fused_stem_remat``): forward split_phases -> K1 (no masks) -> K3b,
    saving only x's phases and y5; backward K3a (g5) -> K5 ->
    merge_phases. Residual memory: xe, xo and y5, no masks."""

    @staticmethod
    def forward(ctx, x, sp, sbp):
        xe, xo = split_phases(x)
        y5p = fused_stem_fwd(xe, xo, sp)
        ctx.save_for_backward(xe, xo, y5p)
        ctx.sp, ctx.sbp = sp, sbp
        return from_planar(y5p, x.shape[1] // 4, 128)

    @staticmethod
    def backward(ctx, g5):
        xe, xo, y5p = ctx.saved_tensors
        g5p = to_planar(g5.to(y5p.dtype).contiguous())
        gxe, gxo = fused_stem_bwd(xe, xo, y5p, g5p, ctx.sp, ctx.sbp)
        return merge_phases(gxe, gxo, xe.shape[1] // 2, 3), None, None


class FusedStemPlanar(torch.autograd.Function):
    """The stem that stops at the planar y5 (the JAX package's
    ``fused_stem_planar``): forward split_phases -> K1 (``save_acts``),
    no K3b; backward from a planar g5 straight to K2 -> merge_phases, no
    K3a."""

    @staticmethod
    def forward(ctx, x, sp, sbp):
        xe, xo = split_phases(x)
        acts = fused_stem_fwd(xe, xo, sp, save_acts=True)
        ctx.save_for_backward(*acts)
        ctx.sbp = sbp
        return acts[0]

    @staticmethod
    def backward(ctx, g5p):
        acts = ctx.saved_tensors
        gxe, gxo = fused_stem_bwd_saved(
            acts, g5p.to(acts[0].dtype).contiguous(), ctx.sbp)
        return merge_phases(gxe, gxo, acts[1].shape[1] // 2, 3), None, None


def fused_stem_remat(x: torch.Tensor, sp: StemParams,
                     sbp: StemBwdParams = None) -> torch.Tensor:
    """``fused_stem`` whose backward recomputes the masks (K5) instead of
    saving them: where autograd records, ``FusedStemRemat``; otherwise
    the forward alone, as ``fused_stem``'s."""
    if _needs_grad(x, sbp, "fused_stem_remat"):
        return FusedStemRemat.apply(x, sp, sbp)
    return fused_stem(x, sp)


def fused_stem_planar(x: torch.Tensor, sp: StemParams,
                      sbp: StemBwdParams = None) -> torch.Tensor:
    """NHWC [B, H, W, 3] (compute dtype) -> planar y5 [B, H/4, 128, Wl5]:
    split_phases -> fused_stem_fwd. Where autograd records,
    ``FusedStemPlanar`` (K1 with masks; a planar g5 back through K2);
    otherwise forward only."""
    if _needs_grad(x, sbp, "fused_stem_planar"):
        return FusedStemPlanar.apply(x, sp, sbp)
    xe, xo = split_phases(x)
    return fused_stem_fwd(xe, xo, sp)
