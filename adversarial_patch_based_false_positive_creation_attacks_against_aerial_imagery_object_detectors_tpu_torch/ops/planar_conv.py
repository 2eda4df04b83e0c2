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
tensor they run ``to_planar_plain`` / ``from_planar_plain``. All are
bound by bytes on the H100 and move 16-byte vectors. ``step``/``offset``
fold a column decimation into ``to_planar``; ``to_planar_phases`` writes
both column phases of step 2 (offset 0 and 1: what
``stem_fused.split_phases`` builds) in one launch.

``planar_conv`` is one conv layer on planar activations (3x3 stride 1 or
2, or 1x1; + bias, optional leaky, optional residual, optional leaky-
backward gate), the Pallas ``planar_conv``: on a CUDA tensor the K4
kernel of ``csrc/planar_conv.cu``, on a CPU tensor ``planar_conv_plain``.
It carries the per-layer planar stem (``models/stem_planar.py``) and the
per-layer planar 152^2 stage (``models/res_planar.py``), forward and
backward; ``expand2_planar`` is the stride-2 adjoint's zero interleave,
``flip_t`` a stride-1 conv's adjoint kernel. ``planar_conv_t2`` is the
stride-2 adjoint ``planar_conv(expand2_planar(g), flip_t(w), ...)`` as
one K4 variant that reads the unexpanded cotangent (its four output
parities, 9 tap products per 4 outputs instead of 36). In bfloat16 K4 runs
on ``wgmma`` with its input loaded by TMA and its weights streamed into
shared memory by bulk copies, packed on the host in the descriptor's
swizzled chunks (``k4_plan``, ``k4_weights``, built once per weight
tensor by ``_mma_cached``); in float32 it keeps CUDA-core FMAs.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

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


def _out_block(out: Optional[torch.Tensor], shape, like: torch.Tensor,
               name: str) -> torch.Tensor:
    """A layout kernel's output: a new block, or ``out`` when the caller
    passes one (the GPU tests and ``chip_smoke.py`` pass blocks filled
    with NaN, so a lane or channel the kernel fails to write shows)."""
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != like.dtype
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous {like.dtype} "
                         f"{tuple(shape)} block on {like.device}")
    return out


def to_planar(x: torch.Tensor, c_pad: Optional[int] = None,
              step: int = 1, offset: int = 0) -> torch.Tensor:
    """``to_planar_plain`` as the K3a kernel on a CUDA tensor: its narrow
    form for C < 32 (the NHWC row staged in shared memory, each output
    vector gathered from the stage), its tiled form for C >= 32 (V x V
    tiles transposed in registers). Each form counts its own launches:
    ``to_planar.launches`` and ``to_planar.tiled_launches``."""
    if x.device.type == "cpu":
        return to_planar_plain(x, c_pad, step, offset)
    return _to_planar_into(x, None, c_pad, step, offset)


def _to_planar_into(x: torch.Tensor, out: Optional[torch.Tensor],
                    c_pad: Optional[int] = None, step: int = 1,
                    offset: int = 0) -> torch.Tensor:
    """``to_planar``'s launch, into ``out`` when it is given."""
    _cuda.require_cuda("to_planar", x)
    b, h, w_in, c = x.shape
    tiled = c >= 32
    w_out, wl, cp = _planar_geometry(w_in, c, c_pad, step, offset)
    out = _out_block(out, (b, h, cp, wl), x, "to_planar")
    _cuda.launch("to_planar", "planar",
                 "apfp_to_planar_tiled" if tiled else "apfp_to_planar", x,
                 x.data_ptr(), out.data_ptr(), _cuda.DTYPE_CODES[x.dtype], b,
                 h, w_in, c, cp, wl, step, offset, w_out)
    if tiled:
        to_planar.tiled_launches += 1
    else:
        to_planar.launches += 1
    return out


def to_planar_phases(x: torch.Tensor, c_pad: Optional[int] = None):
    """The two column phases of step 2, ``(to_planar_plain(x, c_pad, 2,
    0), to_planar_plain(x, c_pad, 2, 1))``; on a CUDA tensor one launch of
    K3a's narrow form (C < 32) writes both from one read of x, counted in
    ``to_planar.phases_launches``. At odd W the even phase holds one
    column more than the odd one."""
    if x.device.type == "cpu":
        return (to_planar_plain(x, c_pad, 2, 0),
                to_planar_plain(x, c_pad, 2, 1))
    return _to_planar_phases_into(x, None, None, c_pad)


def _to_planar_phases_into(x: torch.Tensor, xe: Optional[torch.Tensor],
                           xo: Optional[torch.Tensor],
                           c_pad: Optional[int] = None):
    """``to_planar_phases``' launch, into ``xe`` and ``xo`` when they are
    given."""
    _cuda.require_cuda("to_planar_phases", x)
    b, h, w_in, c = x.shape
    if c >= 32:
        raise ValueError(f"to_planar_phases: C = {c} (the narrow form "
                         "takes C < 32)")
    w_e, wl_e, cp = _planar_geometry(w_in, c, c_pad, 2, 0)
    w_o, wl_o, _ = _planar_geometry(w_in, c, c_pad, 2, 1)
    xe = _out_block(xe, (b, h, cp, wl_e), x, "to_planar_phases")
    xo = _out_block(xo, (b, h, cp, wl_o), x, "to_planar_phases")
    _cuda.launch("to_planar_phases", "planar", "apfp_to_planar_phases", x,
                 x.data_ptr(), xe.data_ptr(), xo.data_ptr(),
                 _cuda.DTYPE_CODES[x.dtype], b, h, w_in, c, cp, wl_e, wl_o,
                 w_e, w_o)
    to_planar.phases_launches += 1
    return xe, xo


def from_planar(xp: torch.Tensor, w_img: Optional[int] = None,
                c: Optional[int] = None) -> torch.Tensor:
    """``from_planar_plain`` as the K3b kernel on a CUDA tensor: its tiled
    form for c >= 32 (``from_planar.launches``), its narrow form for
    c < 32 (the NHWC run staged in shared memory,
    ``from_planar.narrow_launches``)."""
    if xp.device.type == "cpu":
        return from_planar_plain(xp, w_img, c)
    return _from_planar_into(xp, None, w_img, c)


def _from_planar_into(xp: torch.Tensor, out: Optional[torch.Tensor],
                      w_img: Optional[int] = None,
                      c: Optional[int] = None) -> torch.Tensor:
    """``from_planar``'s launch, into ``out`` when it is given."""
    _cuda.require_cuda("from_planar", xp)
    b, h, cp, wl = xp.shape
    w_img = w_img if w_img is not None else h
    c = c if c is not None else cp
    if w_img + 1 > wl or not 0 < c <= cp:
        raise ValueError(f"from_planar: bad geometry {xp.shape}, "
                         f"w_img={w_img}, c={c}")
    narrow = c < 32
    out = _out_block(out, (b, h, w_img, c), xp, "from_planar")
    _cuda.launch("from_planar", "planar",
                 "apfp_from_planar_narrow" if narrow else "apfp_from_planar",
                 xp, xp.data_ptr(), out.data_ptr(),
                 _cuda.DTYPE_CODES[xp.dtype], b, h, cp, wl, w_img, c)
    if narrow:
        from_planar.narrow_launches += 1
    else:
        from_planar.launches += 1
    return out


to_planar.launches = 0
to_planar.tiled_launches = 0
to_planar.phases_launches = 0
from_planar.launches = 0
from_planar.narrow_launches = 0


# ---------------------------------------------------------------------------
# Weights as the bfloat16 tensor-core kernels read them: wgmma's swizzled
# chunks, or mma.sync's fragment order (the k16 step's bit check)
# ---------------------------------------------------------------------------

def mma_weights(w: torch.Tensor) -> torch.Tensor:
    """A conv's weights ``[kh, kw, K, N]`` (tap, then the GEMM's depth K
    and width N: HWIO for a forward conv, ``stem_bwd_params``' layout for
    an adjoint) -> ``mma.sync.m16n8k16``'s B fragments in the order the
    kernels load them, ``[kh*kw, K/16, N/8, 32, 4]``: lane ``4g + t`` of
    the 16-deep step s and 8-wide block j holds ``B[k][8j + g]`` at
    ``k = 16s + 2t + (0, 1, 8, 9)``."""
    kh, kw, k, n = w.shape
    v = w.reshape(kh * kw, k // 16, 2, 4, 2, n // 8, 8)
    return v.permute(0, 1, 5, 6, 3, 2, 4).reshape(
        kh * kw, k // 16, n // 8, 32, 4).contiguous()


def wg_weights(w: torch.Tensor) -> torch.Tensor:
    """One GEMM's weights ``[T, K, N]`` (T taps in the kernel's step
    order, depth K a tap, N output channels) -> the chunks the ``wgmma``
    kernels stream into shared memory, ``[NCH, N, 64]``: the T*K rows of
    depth cut into 64-deep chunks (the last padded with zeros), each chunk
    ``N`` rows of 64 values of k (128 bytes, K-major) whose 16-byte units
    are swizzled as ``wgmma``'s 128-byte-swizzle descriptor reads them:
    element (k, n) of the GEMM lies in chunk ``k // 64`` at byte
    ``n * 128 + (((k % 64) // 8) ^ (n % 8)) * 16 + (k % 8) * 2``
    (``csrc/stem_common.cuh: wg``)."""
    t, k, n = w.shape
    depth = t * k
    nch = -(-depth // 64)
    flat = F.pad(w.reshape(depth, n), (0, 0, 0, nch * 64 - depth))
    v = flat.reshape(nch, 64, n).transpose(1, 2).reshape(nch, n, 8, 8)
    unit = torch.arange(8, device=w.device)
    src = unit[None, :] ^ (torch.arange(n, device=w.device)[:, None] % 8)
    out = torch.gather(v, 2, src[None, :, :, None].expand(nch, n, 8, 8))
    return out.reshape(nch, n, 64).contiguous()


# the wgmma widths K4's blocks take (csrc/planar_conv.cu: wgk::plan)
K4_WIDTHS = (8, 16, 32, 64)


def k4_plan(k: int, stride, cin: int, cout: int):
    """The bfloat16 K4's launch plan for a conv of ``k`` x ``k`` taps at
    ``stride`` (1, 2, or ``"t2"``: the stride-2 adjoint), weights of
    ``cin`` input and ``cout`` output channels (``csrc/planar_conv.cu:
    wgk::plan``): ``(ns, n, n_cb, kdepth)``, the 16-deep steps of a
    channel chunk (1 at stride 2 or for a depth up to 16, 2 up to 32, 4
    past it), the block's channel width (the least of ``K4_WIDTHS`` that
    holds cout, at most 64; the adjoint's, with two accumulator sets, at
    most 32), the channel blocks and the GEMM depth (cin rounded up to
    16)."""
    cap = 32 if stride == "t2" else 64
    n = next((v for v in K4_WIDTHS if v >= min(cout, cap)), cap)
    kdepth = _round_up(cin, 16)
    ns = 1 if (k == 3 and stride == 2) or kdepth <= 16 else \
        2 if kdepth <= 32 else 4
    return ns, n, -(-cout // n), kdepth


def k4_weights(w: torch.Tensor, ns: int, n: int) -> torch.Tensor:
    """The bfloat16 K4's weights from an HWIO ``w`` [k, k, cin', cout] (a
    forward kernel, or ``flip_t``'s for an adjoint) for a plan of ``ns``
    16-deep steps a channel chunk and ``n`` channels a block
    (``k4_plan``): ``[n_cb * nck * wpc, n, 64]`` bfloat16, the chunks the
    kernel streams, channel block after channel block. cin is zero-padded
    to ``nck`` chunks of ``kc = 16 ns`` channels and cout to ``n_cb * n``;
    channel chunk c of block cb is ``wg_weights`` of its taps in row-major
    order ``[k*k, kc, n]`` (``wpc = ceil(k*k ns / 4)`` chunks, the last
    zero-padded): input channel ``c kc + i`` of tap t and output channel
    ``cb n + j`` lie in chunk ``(cb nck + c) wpc + (t kc + i) // 64`` at
    ``wg_weights``' byte of ``(t kc + i) % 64`` and j."""
    kh, kw, cin, cout = w.shape
    kc = 16 * ns
    nck = -(-_round_up(cin, 16) // kc)
    n_cb = -(-cout // n)
    v = F.pad(w.to(torch.bfloat16),
              (0, n_cb * n - cout, 0, nck * kc - cin))
    v = v.reshape(kh * kw, nck, kc, n_cb, n)
    return torch.cat([wg_weights(v[:, c, :, cb])
                      for cb in range(n_cb) for c in range(nck)])


@functools.lru_cache(maxsize=None)
def _k4_builder(ns: int, n: int):
    """``k4_weights`` at one plan, as a build function of ``w`` alone
    (one object per plan: ``_mma_cached``'s key)."""
    def build(w: torch.Tensor) -> torch.Tensor:
        return k4_weights(w, ns, n)
    return build


# the kernels' copies, one per weight tensor and build function (and the
# tensor's version: an inference tensor has none); they go when the
# weights go
_MMA_CACHE = WeakIdKeyDictionary()


def _mma_cached(w: torch.Tensor, build=mma_weights) -> torch.Tensor:
    """``build(w)``, built once per weight tensor (and per ``build``) and
    rebuilt when the tensor is modified in place."""
    version = -1 if w.is_inference() else w._version
    per_w = _MMA_CACHE.get(w)
    if per_w is None:
        per_w = _MMA_CACHE[w] = {}
    hit = per_w.get(build)
    if hit is None or hit[0] != version:
        hit = per_w[build] = (version, build(w))
    return hit[1]


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


def _check_epi(name, xp, b, shape, **opt):
    """The wrapper checks of an epilogue input (res, gate: planar of the
    output's shape and dtype; in bfloat16 16-byte aligned, as the kernel
    reads them 16 bytes at a time) and the bias ([cout] on xp's device)."""
    dt = xp.dtype
    for key, t in opt.items():
        if t is not None and (tuple(t.shape) != shape or t.dtype != dt):
            raise ValueError(f"{name}: {key} {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dt}")
        if t is not None and dt == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    if tuple(b.shape) != (shape[2],) or b.device != xp.device:
        raise ValueError(f"{name}: bias {tuple(b.shape)} on {b.device} for "
                         f"cout={shape[2]} on {xp.device}")


def _kernel_weights(name, xp, w, b, stride=1):
    """(weight, bias, cout_pad, K) as the kernel reads them. bfloat16: the
    packed weights of the plan (``k4_plan``, ``k4_weights``, cached per
    ``w``), cout_pad its channel blocks' width, K the weights' cin rounded
    up to 16, the bias float32 [cout]. float32: HWIO with cin as the
    input's and cout a multiple of 8 (no copy where the caller prepared
    it so), the bias float32 [cout_pad]."""
    if w.device != xp.device:
        raise ValueError(f"{name}: weight on {w.device}, input on "
                         f"{xp.device}")
    k, _, cin, cout = w.shape
    if xp.dtype == torch.bfloat16:
        if xp.data_ptr() % 16:
            raise ValueError(f"{name}: the input must be 16-byte aligned")
        ns, n, n_cb, kdepth = k4_plan(k, stride, cin, cout)
        wk = _mma_cached(w, _k4_builder(ns, n))
        return wk, b.float().contiguous(), n_cb * n, kdepth
    wk = pad_cout(pad_cin(w, xp.shape[2])).to(xp.dtype).contiguous()
    cout_pad = wk.shape[-1]
    bk = b.float().contiguous()
    if cout_pad > cout:
        bk = F.pad(bk, (0, cout_pad - cout))
    return wk, bk, cout_pad, 0


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
    launches the K4 kernel of ``csrc/planar_conv.cu`` (bfloat16 on the
    tensor cores, float32 on CUDA cores), each geometry counting its own
    launches (``planar_conv.launches_k1``, ``.launches_k3``,
    ``.launches_k3s2``; the adjoint variant ``planar_conv_t2`` counts in
    ``.launches_k3t2``); on a CPU tensor it runs ``planar_conv_plain``."""
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
    _check_epi("planar_conv", xp, b, shape, res=res, gate=gate)
    wk, bk, cout_pad, kdepth = _kernel_weights("planar_conv", xp, w, b,
                                                stride)
    out = torch.empty(shape, dtype=dt, device=xp.device)
    _cuda.launch(
        "planar_conv", "planar_conv", "apfp_planar_conv", xp,
        xp.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        res.data_ptr() if res is not None else None,
        gate.data_ptr() if gate is not None else None, out.data_ptr(),
        _cuda.DTYPE_CODES[dt], batch, h_in, cin, wl_in, w_img, cout,
        cout_pad, kdepth, k, stride, int(slope is not None),
        float(slope if slope is not None else 0.0), float(gate_slope))
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
planar_conv.launches_k3t2 = 0


def planar_conv_t2_plain(g: torch.Tensor, w_t: torch.Tensor,
                         b: torch.Tensor, *, w_img: int,
                         gate: Optional[torch.Tensor] = None,
                         gate_slope: float = 0.1) -> torch.Tensor:
    """The k3t2 variant's plain version, the JAX package's formulation of
    a stride-2 conv's input cotangent: the zero interleave, then the
    stride-1 conv with the flipped kernel."""
    return planar_conv_plain(expand2_planar(g, w_img), w_t, b, k=3,
                             slope=None, w_img=2 * w_img, gate=gate,
                             gate_slope=gate_slope)


def planar_conv_t2(g: torch.Tensor, w_t: torch.Tensor, b: torch.Tensor, *,
                   w_img: int, gate: Optional[torch.Tensor] = None,
                   gate_slope: float = 0.1) -> torch.Tensor:
    """``planar_conv(expand2_planar(g, w_img), w_t, b, k=3, slope=None,
    gate=gate)`` without the interleave: ``g`` planar [B, H, cin, Wl] at
    image width ``w_img`` (the stride-2 conv's output cotangent), ``w_t``
    its flipped kernel (``flip_t``) HWIO [3, 3, cin', cout], ``b`` [cout],
    ``gate`` planar [B, 2H, cout, Wl'] or None. Returns planar
    [B, 2H, cout, Wl'] at width 2 ``w_img``. On a CUDA tensor the K4
    adjoint variant of ``csrc/planar_conv.cu`` (its four output parities
    from the unexpanded g), counted in ``planar_conv.launches_k3t2``; on a
    CPU tensor ``planar_conv_t2_plain``."""
    batch, h_in, cin, wl_in = g.shape
    if (w_t.dim() != 4 or tuple(w_t.shape[:2]) != (3, 3)
            or w_t.shape[2] > cin):
        raise ValueError(f"planar_conv_t2: weight {tuple(w_t.shape)} for "
                         f"cin={cin}")
    if wl_in != _round_up(w_img + 2, 128):
        raise ValueError(f"planar_conv_t2: bad planar geometry "
                         f"{tuple(g.shape)} for w_img={w_img}")
    if g.device.type == "cpu":
        return planar_conv_t2_plain(g, w_t, b, w_img=w_img, gate=gate,
                                    gate_slope=gate_slope)
    opt = [gate] if gate is not None else []
    _cuda.require_cuda("planar_conv_t2", g, *opt)
    cout = w_t.shape[-1]
    shape = (batch, 2 * h_in, cout, _round_up(2 * w_img + 2, 128))
    _check_epi("planar_conv_t2", g, b, shape, gate=gate)
    wk, bk, cout_pad, kdepth = _kernel_weights("planar_conv_t2", g, w_t, b,
                                                "t2")
    out = torch.empty(shape, dtype=g.dtype, device=g.device)
    _cuda.launch(
        "planar_conv_t2", "planar_conv", "apfp_planar_conv_t2", g,
        g.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        gate.data_ptr() if gate is not None else None, out.data_ptr(),
        _cuda.DTYPE_CODES[g.dtype], batch, h_in, cin, wl_in, w_img, cout,
        cout_pad, kdepth, float(gate_slope))
    planar_conv.launches_k3t2 += 1
    return out
