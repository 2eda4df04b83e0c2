"""Matmul-factored affine warp of the EOT (the default route).

The JAX package's ``ops/affine_mxu.py``: the inverse-affine bilinear warp
factored into two 1-D interpolation passes, each a batched matrix
product,

    src = A @ out + t,  A = [[a, b], [c, d]]
        = X @ Y with X = [[det/d, b/d], [0, 1]],  Y = [[1, 0], [c, d]]

    pass X:  mid[y, X]  = sum_x hat(p*X + q*y + u1 - x) * img[y, x]
    pass Y:  out[Y, X]  = sum_y hat(c*X + d*Y + v2 - y) * mid[y, X]

with hat(t) = max(0, 1-|t|). When ``|d| < |b|`` the factor is
ill-conditioned, so the source is transposed per sample and the
coefficient rows swapped. Exact bilinear for axis-aligned transforms; a
small sheared-interpolation residual under rotation. The mask rides
along as a ones channel; ``theta`` is not differentiated. The hat
matrices are built in float32 (their arguments index up to 608 pixel
positions) and cast to the warp dtype; passes are chunked over source
rows and output columns so that one hat-matrix chunk stays within a
fixed byte budget.

``affine_warp_mxu_plain`` is that warp as plain batched products
(``torch.einsum``), as the JAX package left them to XLA outside any
kernel. ``affine_warp_mxu`` runs it on a CPU tensor; on a CUDA tensor it
launches the kernel pair of ``csrc/affine_warp.cu`` (a
``torch.autograd.Function``), which evaluates each hat only at its two
non-zero taps and builds no hat matrix: the forward (counted in
``affine_warp_mxu.launches``) writes the one [B, oh, ow, C+1] buffer whose
two views it returns, the backward into the patch (counted in
``affine_warp_mxu.bwd_launches``) gathers over each source position's
window of outputs. Both read the coefficients below, computed once in
torch by the plain version's code (``_kernel_coeffs``), and round where
the einsums round. The mask does not depend on the patch, so there it is
marked non-differentiable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from .affine import _affine_pixel_coeffs

# float32 elements of one hat-matrix chunk (1 GiB)
_CHUNK_BUDGET = 1024 * 1024 * 1024 // 4


def _hat(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def _factored_coeffs(theta: torch.Tensor, out_hw: Tuple[int, int],
                     src_hw: Tuple[int, int], offset: Tuple[float, float]):
    """The factored warp's per-sample coefficients, each [B]: the
    conditioning swap (transpose the source, swap the coefficient rows
    where ``|a12| > |a22|``), pass X's ``p, q, u1`` and pass Y's
    ``A21, A22, B2``."""
    a11, a12, a21, a22, b1, b2 = _affine_pixel_coeffs(
        theta, out_hw, src_hw, offset)
    swap = torch.abs(a12) > torch.abs(a22)

    def sel(p, q):
        return torch.where(swap, q, p)

    A11, A12, B1 = sel(a11, a21), sel(a12, a22), sel(b1, b2)
    A21, A22, B2 = sel(a21, a11), sel(a22, a12), sel(b2, b1)
    d = A22
    safe_d = torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12), d)
    det = A11 * A22 - A12 * A21
    p = det / safe_d
    q = A12 / safe_d
    u1 = B1 - q * B2
    return swap, p, q, u1, A21, A22, B2


def _check_square(img: torch.Tensor) -> None:
    if img.shape[1] != img.shape[2]:
        raise ValueError("the factored warp needs a square source")


def affine_warp_mxu_plain(img: torch.Tensor, theta: torch.Tensor,
                          out_hw: Tuple[int, int],
                          src_hw: Optional[Tuple[int, int]] = None,
                          offset: Tuple[float, float] = (0.0, 0.0)):
    """``affine_warp_mxu`` as dense hat matrices and ``torch.einsum``, on
    any device (the CPU path, and the card's yardstick)."""
    theta = theta.detach()
    _check_square(img)
    b, h, w, c = img.shape
    oh, ow = out_hw
    src = tuple(src_hw) if src_hw is not None else (h, w)
    swap, p, q, u1, A21, A22, B2 = _factored_coeffs(theta, out_hw, src,
                                                    offset)
    img_t = torch.where(swap[:, None, None, None], img.transpose(1, 2), img)

    # ones channel rides along to produce the mask
    ones = torch.ones((b, h, w, 1), dtype=img.dtype, device=img.device)
    x4 = torch.cat([img_t, ones], dim=-1)              # [B, h, w, C+1]

    f32 = dict(dtype=torch.float32, device=img.device)
    xs = torch.arange(w, **f32)
    ys = torch.arange(h, **f32)
    Xs = torch.arange(ow, **f32)
    Ys = torch.arange(oh, **f32)

    # pass X: [B, h, ow, C+1], chunked over source rows y
    # M1[b, y, X, x] = hat(p X + q y + u1 - x)
    y_chunk = max(8, min(h, _CHUNK_BUDGET // max(b * ow * w, 1)))
    mids = []
    for y0 in range(0, h, y_chunk):
        yc = ys[y0:y0 + y_chunk]
        argx = (p[:, None, None] * Xs[None, None, :]
                + q[:, None, None] * yc[None, :, None]
                + u1[:, None, None])                   # [B, yc, ow]
        m1 = _hat(argx[..., None] - xs)                # [B, yc, ow, w]
        mids.append(torch.einsum("byXx,byxc->byXc", m1.to(img.dtype),
                                 x4[:, y0:y0 + y_chunk]))
    mid = torch.cat(mids, dim=1)                       # [B, h, ow, C+1]

    # pass Y: [B, oh, ow, C+1], chunked over output columns X
    # M2[b, X, Y, y] = hat(r X + s Y + v2 - y),  r = A21, s = A22, v2 = B2
    x_chunk = max(8, min(ow, _CHUNK_BUDGET // max(b * oh * h, 1)))
    outs = []
    for x0 in range(0, ow, x_chunk):
        xc = Xs[x0:x0 + x_chunk]
        arg = (A21[:, None, None] * xc[None, :, None]
               + A22[:, None, None] * Ys[None, None, :]
               + B2[:, None, None])                    # [B, cw, oh]
        m2 = _hat(arg[..., None] - ys)                 # [B, cw, oh, h]
        outs.append(torch.einsum("bXYy,byXc->bYXc", m2.to(img.dtype),
                                 mid[:, :, x0:x0 + x_chunk, :]))
    out4 = torch.cat(outs, dim=2)                      # [B, oh, ow, C+1]
    return out4[..., :c], out4[..., c:]


def _kernel_coeffs(theta: torch.Tensor, out_hw: Tuple[int, int],
                   src_hw: Tuple[int, int],
                   offset: Tuple[float, float]) -> torch.Tensor:
    """``_factored_coeffs`` as the kernels read them: [B, 7] float32,
    the columns p, q, u1, A21, A22, B2 and the swap flag (1 or 0)."""
    swap, *coeffs = _factored_coeffs(theta, out_hw, src_hw, offset)
    return torch.stack(coeffs + [swap.float()], dim=1)


def _warp_fwd(img: torch.Tensor, coef: torch.Tensor,
              out_hw: Tuple[int, int]) -> torch.Tensor:
    """The forward kernel: ``img`` [B, n, n, 3] and ``coef`` (the
    ``_kernel_coeffs``), contiguous on the card -> [B, oh, ow, 4]."""
    oh, ow = out_hw
    b, n, _, c = img.shape
    out4 = torch.empty((b, oh, ow, c + 1), dtype=img.dtype,
                       device=img.device)
    if out4.numel():
        _cuda.launch("affine_warp_mxu", "affine_warp",
                     "apfp_affine_warp_fwd", img, img.data_ptr(),
                     coef.data_ptr(), out4.data_ptr(),
                     _cuda.DTYPE_CODES[img.dtype], b, n, oh, ow)
        affine_warp_mxu.launches += 1
    return out4


def _warp_bwd(g: torch.Tensor, coef: torch.Tensor,
              src_shape) -> torch.Tensor:
    """The backward kernel: the cotangent ``g`` [B, oh, ow, 3] of the
    warped channels, contiguous -> the source's [B, n, n, 3]."""
    gsrc = torch.empty(src_shape, dtype=g.dtype, device=g.device)
    if gsrc.numel():
        _cuda.launch("affine_warp_mxu_bwd", "affine_warp",
                     "apfp_affine_warp_bwd", g, g.data_ptr(),
                     coef.data_ptr(), gsrc.data_ptr(),
                     _cuda.DTYPE_CODES[g.dtype], src_shape[0], src_shape[1],
                     g.shape[1], g.shape[2])
        affine_warp_mxu.bwd_launches += 1
    return gsrc


class _FactoredWarp(torch.autograd.Function):
    """The kernel pair on CUDA tensors: (out, mask), two views of one
    buffer. The backward needs only the coefficients: the warp is linear
    in ``img``, and the mask does not depend on it."""

    @staticmethod
    def forward(ctx, img, coef, out_hw):
        out4 = _warp_fwd(img, coef, out_hw)
        c = img.shape[-1]
        out, mask = out4[..., :c], out4[..., c:]
        ctx.mark_non_differentiable(mask)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(coef)
        ctx.src_shape = img.shape
        return out, mask

    @staticmethod
    def backward(ctx, g, _):
        if g is None:
            return None, None, None
        (coef,) = ctx.saved_tensors
        return _warp_bwd(g.contiguous(), coef, ctx.src_shape), None, None


def affine_warp_mxu(img: torch.Tensor, theta: torch.Tensor,
                    out_hw: Tuple[int, int],
                    src_hw: Optional[Tuple[int, int]] = None,
                    offset: Tuple[float, float] = (0.0, 0.0)):
    """Warp square ``img`` [B, P, P, C] by per-sample affines ``theta``
    (affine_grid convention). Returns (out [B, oh, ow, C],
    mask [B, oh, ow, 1]): two views of one [B, oh, ow, C+1] buffer. A CPU
    tensor takes ``affine_warp_mxu_plain``; anything else launches the
    kernel pair (float32 or bfloat16 RGB; the mask then carries no
    gradient) or raises."""
    if img.device.type == "cpu":
        return affine_warp_mxu_plain(img, theta, out_hw, src_hw, offset)
    _check_square(img)
    img = img.contiguous()
    theta = theta.detach().float()
    _cuda.require_cuda("affine_warp_mxu", img)
    b, h, w, c = img.shape
    if c != 3:
        raise ValueError(f"affine_warp_mxu: {c} channels; the kernels warp "
                         "RGB")
    if theta.shape != (b, 2, 3) or theta.device != img.device:
        raise ValueError(f"affine_warp_mxu: theta must be [{b}, 2, 3] on "
                         f"{img.device}")
    src = tuple(src_hw) if src_hw is not None else (h, w)
    return _FactoredWarp.apply(
        img, _kernel_coeffs(theta, out_hw, src, offset), tuple(out_hw))


affine_warp_mxu.launches = 0
affine_warp_mxu.bwd_launches = 0
