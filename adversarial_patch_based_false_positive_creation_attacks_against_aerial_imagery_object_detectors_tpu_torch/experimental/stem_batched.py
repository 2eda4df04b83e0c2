"""The batch-on-lanes fused stem (K8a forward, K8b input backward), the JAX
package's ``experimental/stem_batched.py``.

The same stem as ``ops/stem_fused.py`` (layers 0-5 of YOLOv3, forward and
the input-cotangent chain), but in the JAX module's layout: a row is
``[C, B*seg]`` with every image of the batch on the lanes, image b's
column j at lane ``b*seg + j + 1`` (``seg = _seg(H/2)``), the border and
slack lanes zero. conv5 runs lane-dense (stride 2 in rows, 1 in columns),
so y5 comes out at every s4 column and the layout glue keeps the even
ones; the backward takes the gated cotangent zero-interleaved in rows and
lanes, so its conv5 adjoint is a plain stride-1 transposed conv.

- Layout helpers (``nhwc_to_batched``, ``batched_to_nhwc``,
  ``split_phases_b``, ``merge_phases_b``, ``interleave_zero_cols``,
  ``interleave_zero_rows``, ``_lane_mask``): plain PyTorch, as the JAX
  module's are XLA.
- ``fused_stem_fwd_b`` (K8a) and ``fused_stem_bwd_b`` (K8b) launch the
  hand-written kernels of ``csrc/stem_batched.cu`` on CUDA tensors and run
  their plain versions (``F.conv2d`` / ``F.conv_transpose2d`` chains with
  the kernels' rounding points) on CPU tensors; anything else raises.
  In bfloat16 both run on Hopper's ``wgmma``, on the fused stem's code:
  K8a K1's convs on K1's packed weights (``k1_packed``), K8b K2's chain on
  K2's packed adjoints (``k2_packed``) with its inputs brought by TMA;
  float32 keeps the CUDA-core kernels. Launch counts:
  ``fused_stem_fwd_b.launches`` and ``.save_acts_launches``,
  ``fused_stem_bwd_b.launches``.
- ``fused_stem_batched`` / ``FusedStemBatched``: NHWC in, NHWC
  ``[B, H/4, W/4, 128]`` out; the backward returns the input cotangent
  only. The JAX module's tiling knobs (``s5``, ``interpret``) are gone: the
  function does not depend on them. Their shape preconditions stay:
  H % 8 == 0, W == H and 3 channels.

Not wired into any path: the training stem is ``ops/stem_fused.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops.planar_conv import _round_up
from ..ops.stem_fused import (LEAKY, StemBwdParams, StemParams, _needs_grad,
                              _check_stem_bwd_params, _check_stem_params,
                              k1_packed, k2_packed)


# ---------------------------------------------------------------------------
# Layout (plain PyTorch)
# ---------------------------------------------------------------------------

def _seg(w_vals: int) -> int:
    return _round_up(w_vals + 2, 128)


def nhwc_to_batched(x: torch.Tensor, seg: int) -> torch.Tensor:
    """NHWC [B, H, W, C] -> batched planar [H, C, B*seg] (value j at
    segment lane j+1)."""
    b, h, w, c = x.shape
    p = torch.zeros((b, h, c, seg), dtype=x.dtype, device=x.device)
    p[:, :, :, 1:w + 1] = x.permute(0, 1, 3, 2)
    return p.permute(1, 2, 0, 3).reshape(h, c, b * seg)


def batched_to_nhwc(p: torch.Tensor, bsz: int, w: int, c: int,
                    lane0: int = 1, stride: int = 1) -> torch.Tensor:
    """Batched planar [H, C', B*seg] -> NHWC [B, H, W, c]; ``lane0`` /
    ``stride`` select the value lanes (stride=2 decimates a dense row)."""
    h, cp, tot = p.shape
    seg = tot // bsz
    q = p.reshape(h, cp, bsz, seg)[:, :c, :, lane0:lane0 + stride * w:stride]
    return q.permute(2, 0, 3, 1)


def split_phases_b(x: torch.Tensor, seg: int):
    """NHWC [B, H, W, C<=8] -> (E, O) batched planar, C padded to 8."""
    c = x.shape[-1]
    if c < 8:
        x = F.pad(x, (0, 8 - c))
    return (nhwc_to_batched(x[:, :, 0::2], seg),
            nhwc_to_batched(x[:, :, 1::2], seg))


def merge_phases_b(pe: torch.Tensor, po: torch.Tensor, bsz: int,
                   w_half: int, c: int) -> torch.Tensor:
    e = batched_to_nhwc(pe, bsz, w_half, c)
    o = batched_to_nhwc(po, bsz, w_half, c)
    b, h = e.shape[:2]
    return torch.stack([e, o], dim=3).reshape(b, h, 2 * w_half, c)


def interleave_zero_cols(g: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, H, 2W, C] with g at even w positions."""
    b, h, w, c = g.shape
    return torch.stack([g, torch.zeros_like(g)], dim=3).reshape(
        b, h, 2 * w, c)


def interleave_zero_rows(g: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, 2H, W, C] with g at even h positions."""
    b, h, w, c = g.shape
    return torch.stack([g, torch.zeros_like(g)], dim=2).reshape(
        b, 2 * h, w, c)


def _lane_mask(bsz: int, seg: int, w_vals: int) -> torch.Tensor:
    """[1, B*seg] float32: 1 on value lanes (1..w_vals per segment)."""
    lane = torch.arange(seg)
    one = (lane >= 1) & (lane <= w_vals)
    return one.to(torch.float32).repeat(bsz)[None]


# ---------------------------------------------------------------------------
# K8a: the forward
# ---------------------------------------------------------------------------

def _check_geometry(name: str, h: int, tot: int, bsz: int) -> None:
    if bsz < 1 or h % 8 or tot != bsz * _seg(h // 2):
        raise ValueError(f"{name}: H={h} must be a multiple of 8 and the "
                         f"lanes {tot} = B * _seg(H/2) for B={bsz}")


def fused_stem_fwd_b_plain(xe: torch.Tensor, xo: torch.Tensor,
                           sp: StemParams, bsz: int, save_acts: bool = False):
    """K8a's plain version: batched phases [H, 8, B*seg] -> lane-dense y5
    [H/4, 128, B*seg] (+ ``(y0e, y0o, y1, y2, y3)``, the activations in the
    compute dtype, y3 before the shortcut sum, with ``save_acts``). float32
    accumulation; each activation rounded to the compute dtype, and
    s4 = y3 + y1 rounded, as the Pallas ``_fwd_kernel_b`` stores."""
    dt = xe.dtype
    h, _, tot = xe.shape
    _check_geometry("fused_stem_fwd_b", h, tot, bsz)
    seg = tot // bsz
    x = merge_phases_b(xe, xo, bsz, h // 2, 3)

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
        y5 = conv(s4, *sp[4], (2, 1))

    def batched(y):
        return nhwc_to_batched(y.permute(0, 2, 3, 1).to(dt), seg)

    if not save_acts:
        return batched(y5)
    return (batched(y5), batched(y0[..., 0::2]), batched(y0[..., 1::2]),
            batched(y1), batched(y2), batched(y3))


def fused_stem_fwd_b(xe: torch.Tensor, xo: torch.Tensor, sp: StemParams,
                     bsz: int, save_acts: bool = False):
    """Batched planar phases [H, 8, B*seg] -> lane-dense planar y5
    [H/4, 128, B*seg] (+ the activations ``(y0e, y0o, y1, y2, y3)`` when
    ``save_acts``; see the plain version). ``sp``: the fused stem's
    (HWIO weight in the compute dtype, float32 bias) pairs
    (``Darknet.stem_params()``). In bfloat16 the kernel runs K1's
    ``wgmma`` convs on K1's packed weights (``k1_packed``), so its
    decimated y5 and its activations' signs are K1's. The two
    instantiations count their own launches: ``fused_stem_fwd_b.launches``
    and ``.save_acts_launches``."""
    if xe.device.type == "cpu":
        return fused_stem_fwd_b_plain(xe, xo, sp, bsz, save_acts)
    _cuda.require_cuda("fused_stem_fwd_b", xe, xo)
    h, cp, tot = xe.shape
    dt = xe.dtype
    _check_geometry("fused_stem_fwd_b", h, tot, bsz)
    if xo.shape != xe.shape or xo.dtype != dt or cp != 8:
        raise ValueError(f"fused_stem_fwd_b: bad phases {tuple(xe.shape)} "
                         f"{dt}, {tuple(xo.shape)} {xo.dtype}")
    _check_stem_params(sp, dt, xe.device)
    h1 = h // 2
    # the kernel writes every lane, borders and slack included
    y5 = torch.empty((h // 4, 128, tot), dtype=dt, device=xe.device)
    acts = []
    if save_acts:
        acts = [torch.empty((rows, c, tot), dtype=dt, device=xe.device)
                for rows, c in ((h, 32), (h, 32), (h1, 64), (h1, 32),
                                (h1, 64))]
    act_ptrs = [a.data_ptr() for a in acts] or [None] * 5
    # bfloat16 on wgmma (K1's packed weights), float32 on sp
    packed = k1_packed(sp) if dt == torch.bfloat16 else [None] * 5
    _cuda.launch(
        "fused_stem_fwd_b", "stem_batched", "apfp_fused_stem_fwd_b", xe,
        xe.data_ptr(), xo.data_ptr(), *[w.data_ptr() for w, _ in sp],
        *[b.data_ptr() for _, b in sp], *packed, y5.data_ptr(), *act_ptrs,
        _cuda.DTYPE_CODES[dt], bsz, h, tot // bsz)
    if save_acts:
        fused_stem_fwd_b.save_acts_launches += 1
        return (y5, *acts)
    fused_stem_fwd_b.launches += 1
    return y5


fused_stem_fwd_b.launches = 0
fused_stem_fwd_b.save_acts_launches = 0


# ---------------------------------------------------------------------------
# K8b: the input backward from the saved activations
# ---------------------------------------------------------------------------

def fused_stem_bwd_b_plain(gp5dd: torch.Tensor, acts, sbp: StemBwdParams,
                           bsz: int):
    """K8b's plain version: (the gated, zero-interleaved conv5 cotangent
    [H/2, 128, B*seg], ``fused_stem_fwd_b(save_acts=True)``'s outputs,
    whose y5 is not read) -> phase-split batched input cotangent (gxe,
    gxo), [H, 8, B*seg] each. ``F.conv_transpose2d`` chains in float32
    that round to the compute dtype where the Pallas ``_bwd_kernel_b``
    stores, gated by 1 where the saved activation is > 0, else 0.1."""
    _, y0e, y0o, y1, y2, y3 = acts
    dt = y0e.dtype
    h, _, tot = y0e.shape
    _check_geometry("fused_stem_bwd_b", h, tot, bsz)
    h1, seg = h // 2, tot // bsz

    def nchw(p, c):
        return batched_to_nhwc(p, bsz, h1, c).permute(0, 3, 1, 2).float()

    def gate(v):
        return torch.where(v > 0, 1.0, LEAKY)

    def rnd(v):
        return v.to(dt).float()

    # [cout, cin, kh, kw]: conv_transpose2d's weight is the forward's
    wt = [v.permute(2, 3, 0, 1).float() for v in sbp]
    with _cuda.no_tf32():
        gs4 = rnd(F.conv_transpose2d(nchw(gp5dd, 128), wt[4], padding=1))
        gp3 = rnd(gs4 * gate(nchw(y3, 64)))
        gp2 = rnd(F.conv_transpose2d(gp3, wt[3], padding=1)
                  * gate(nchw(y2, 32)))
        gp1 = rnd((F.conv_transpose2d(gp2, wt[2]) + gs4)
                  * gate(nchw(y1, 64)))
        y0 = merge_phases_b(y0e, y0o, bsz, h1, 32).permute(0, 3, 1, 2)
        gp0 = rnd(F.conv_transpose2d(gp1, wt[1], stride=2, padding=1,
                                     output_padding=1) * gate(y0.float()))
        gx = F.conv_transpose2d(gp0, wt[0], padding=1).to(dt)
    gx = gx.permute(0, 2, 3, 1)
    return (nhwc_to_batched(gx[:, :, 0::2], seg),
            nhwc_to_batched(gx[:, :, 1::2], seg))


def fused_stem_bwd_b(gp5dd: torch.Tensor, acts, sbp: StemBwdParams,
                     bsz: int):
    """``fused_stem_bwd_b_plain`` as the K8b kernel on CUDA tensors,
    counted in ``fused_stem_bwd_b.launches``. ``acts``: K8a's six outputs
    with ``save_acts`` (y5 is not read); ``sbp``: K2's swapped-channel
    weights (``Darknet.stem_bwd_params()``).

    Contract (the JAX kernel's): ``gp5dd`` is the conv5 cotangent already
    leaky-gated by y5's sign and zero-interleaved in rows and lanes, as
    ``FusedStemBatched.backward`` builds it: gp5 (r, c) at row 2r, lane
    2c + 1 of its image's segment, zero elsewhere. The bfloat16 kernel
    reads only those data positions (a tensor map over the even rows; the
    odd lanes of its boxes) and runs conv5's adjoint as K2's four stride-2
    parity GEMMs on them (the plain version's dense stride-1
    ``conv_transpose2d`` over the interleaved tensor is the same function
    there); the float32 kernel reads the whole tensor."""
    _, y0e, y0o, y1, y2, y3 = acts
    if gp5dd.device.type == "cpu":
        return fused_stem_bwd_b_plain(gp5dd, acts, sbp, bsz)
    _cuda.require_cuda("fused_stem_bwd_b", gp5dd, y0e, y0o, y1, y2, y3)
    dt = y0e.dtype
    h, _, tot = y0e.shape
    _check_geometry("fused_stem_bwd_b", h, tot, bsz)
    h1 = h // 2
    want = {"gp5dd": (gp5dd, (h1, 128)), "y0e": (y0e, (h, 32)),
            "y0o": (y0o, (h, 32)), "y1": (y1, (h1, 64)),
            "y2": (y2, (h1, 32)), "y3": (y3, (h1, 64))}
    bad = [k for k, (t, (rows, c)) in want.items()
           if tuple(t.shape) != (rows, c, tot) or t.dtype != dt]
    if bad:
        raise ValueError(f"fused_stem_bwd_b: bad geometry or dtype {bad} for "
                         f"y0e {tuple(y0e.shape)} {dt}")
    _check_stem_bwd_params(sbp, dt, y0e.device)
    # the kernel writes every lane, borders and slack included
    gxe = torch.empty((h, 8, tot), dtype=dt, device=y0e.device)
    gxo = torch.empty_like(gxe)
    # bfloat16 on wgmma (K2's packed adjoints), float32 on sbp
    packed = k2_packed(sbp) if dt == torch.bfloat16 else [None] * 5
    _cuda.launch(
        "fused_stem_bwd_b", "stem_batched", "apfp_fused_stem_bwd_b", y0e,
        gp5dd.data_ptr(), y0e.data_ptr(), y0o.data_ptr(), y1.data_ptr(),
        y2.data_ptr(), y3.data_ptr(), *[v.data_ptr() for v in sbp], *packed,
        gxe.data_ptr(), gxo.data_ptr(), _cuda.DTYPE_CODES[dt], bsz, h,
        tot // bsz)
    fused_stem_bwd_b.launches += 1
    return gxe, gxo


fused_stem_bwd_b.launches = 0


# ---------------------------------------------------------------------------
# The autograd Function (NHWC in / NHWC out)
# ---------------------------------------------------------------------------

def _check_input(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[1] % 8 or x.shape[2] != x.shape[1] \
            or x.shape[3] != 3:
        raise ValueError(f"fused_stem_batched: expected NHWC [B, H, H, 3] "
                         f"with H % 8 == 0, got {tuple(x.shape)}")


class FusedStemBatched(torch.autograd.Function):
    """The JAX module's ``fused_stem_batched`` custom VJP: forward
    ``split_phases_b`` -> K8a (``save_acts``) -> ``batched_to_nhwc`` of the
    even dense lanes; backward: g5 gated by y5's sign, zero-interleaved in
    columns and rows, ``nhwc_to_batched`` -> K8b -> ``merge_phases_b``.
    Only the input cotangent is returned."""

    @staticmethod
    def forward(ctx, x, sp, sbp):
        b, h = x.shape[0], x.shape[1]
        xe, xo = split_phases_b(x, _seg(h // 2))
        acts = fused_stem_fwd_b(xe, xo, sp, b, save_acts=True)
        out = batched_to_nhwc(acts[0], b, h // 4, 128, lane0=1,
                              stride=2).contiguous()
        ctx.save_for_backward(*acts[1:], out)
        ctx.sbp = sbp
        return out

    @staticmethod
    def backward(ctx, g5):
        *acts, y5 = ctx.saved_tensors
        dt, h = acts[0].dtype, acts[0].shape[0]
        b = y5.shape[0]
        # leaky-gate at quarter resolution, then zero-interleave columns and
        # rows to half-resolution density: K8b's conv5 adjoint is stride 1
        gp5 = g5.float() * torch.where(y5 > 0, 1.0, LEAKY)
        gp5dd = nhwc_to_batched(interleave_zero_rows(interleave_zero_cols(
            gp5.to(dt))), _seg(h // 2))
        gxe, gxo = fused_stem_bwd_b(gp5dd, (None, *acts), ctx.sbp, b)
        return merge_phases_b(gxe, gxo, b, h // 2, 3), None, None


def fused_stem_batched(x: torch.Tensor, sp: StemParams,
                       sbp: StemBwdParams = None) -> torch.Tensor:
    """NHWC [B, H, H, 3] (compute dtype) -> NHWC [B, H/4, H/4, 128] on the
    batch-on-lanes kernels. Where autograd records (``x.requires_grad``),
    ``FusedStemBatched`` with K2's weights ``sbp``; otherwise the forward
    alone (K8a without ``save_acts``)."""
    _check_input(x)
    if _needs_grad(x, sbp, "fused_stem_batched"):
        return FusedStemBatched.apply(x, sp, sbp)
    b, h = x.shape[0], x.shape[1]
    xe, xo = split_phases_b(x, _seg(h // 2))
    y5d = fused_stem_fwd_b(xe, xo, sp, b)
    return batched_to_nhwc(y5d, b, h // 4, 128, lane0=1, stride=2)
