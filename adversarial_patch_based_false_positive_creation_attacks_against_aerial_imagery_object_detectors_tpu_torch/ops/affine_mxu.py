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

These are plain batched products (``torch.einsum``), as the JAX package
left them to XLA outside any kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .affine import _affine_pixel_coeffs

# float32 elements of one hat-matrix chunk (1 GiB)
_CHUNK_BUDGET = 1024 * 1024 * 1024 // 4


def _hat(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def affine_warp_mxu(img: torch.Tensor, theta: torch.Tensor,
                    out_hw: Tuple[int, int],
                    src_hw: Optional[Tuple[int, int]] = None,
                    offset: Tuple[float, float] = (0.0, 0.0)):
    """Warp square ``img`` [B, P, P, C] by per-sample affines ``theta``
    (affine_grid convention). Returns (out [B, oh, ow, C],
    mask [B, oh, ow, 1])."""
    theta = theta.detach()
    b, h, w, c = img.shape
    if h != w:
        raise ValueError("the factored warp needs a square source")
    oh, ow = out_hw
    src = tuple(src_hw) if src_hw is not None else (h, w)
    a11, a12, a21, a22, b1, b2 = _affine_pixel_coeffs(
        theta, out_hw, src, offset)

    # per-sample conditioning swap: transpose source, swap coefficient rows
    swap = torch.abs(a12) > torch.abs(a22)

    def sel(p, q):
        return torch.where(swap, q, p)

    A11, A12, B1 = sel(a11, a21), sel(a12, a22), sel(b1, b2)
    A21, A22, B2 = sel(a21, a11), sel(a22, a12), sel(b2, b1)
    img_t = torch.where(swap[:, None, None, None], img.transpose(1, 2), img)

    # ones channel rides along to produce the mask
    ones = torch.ones((b, h, w, 1), dtype=img.dtype, device=img.device)
    x4 = torch.cat([img_t, ones], dim=-1)              # [B, h, w, C+1]

    d = A22
    safe_d = torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12), d)
    det = A11 * A22 - A12 * A21
    p = det / safe_d
    q = A12 / safe_d
    u1 = B1 - q * B2

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
