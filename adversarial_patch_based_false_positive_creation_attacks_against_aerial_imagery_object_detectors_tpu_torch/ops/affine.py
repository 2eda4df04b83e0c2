"""Batched inverse-affine bilinear warp of the EOT (the exact route).

The JAX package's ``ops/affine.py``: the 2x3 ``theta`` maps output
normalized coordinates (``align_corners=False``) to *source* normalized
coordinates, exactly the ``affine_grid`` contract, and sampling is
bilinear with zeros outside the source. As there, the patch is not
padded onto a canvas: it is sampled at ``canvas_coord - offset`` (zero
padding makes the warp translation equivariant), and the mask (the
reference's warped all-ones canvas) is the warped ones channel.

Sampling is ``F.grid_sample(align_corners=False, padding_mode="zeros")``
on the unpadded patch; its autograd backward replaces the JAX package's
windowed-gather VJP, which exists only because a scatter is slow on a
TPU. ``theta`` gets no gradient (the EOT geometry is random, never
optimized).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rotation_scale_translation_theta(angle: torch.Tensor,
                                     scale: torch.Tensor, tx: torch.Tensor,
                                     ty: torch.Tensor) -> torch.Tensor:
    """The reference's EOT affine: inverse map combining rotation by
    ``angle``, zoom by ``scale``, and translation such that the patch
    center lands at normalized target offset (tx, ty) =
    ((0.5 - x)*2, (0.5 - y)*2). All args are [B]; returns [B, 2, 3]."""
    sin, cos = torch.sin(angle), torch.cos(angle)
    inv = 1.0 / scale
    row0 = torch.stack([cos * inv, sin * inv, (tx * cos + ty * sin) * inv],
                       -1)
    row1 = torch.stack([-sin * inv, cos * inv,
                        (-tx * sin + ty * cos) * inv], -1)
    return torch.stack([row0, row1], dim=1)


def _affine_pixel_coeffs(theta: torch.Tensor, out_hw: Tuple[int, int],
                         src_hw: Tuple[int, int],
                         offset: Tuple[float, float]):
    """Source pixel coords as an explicit affine of output pixel coords:
    ix = a11*ox + a12*oy + b1 ; iy = a21*ox + a22*oy + b2. Returns the six
    per-sample coefficients (each [B])."""
    oh, ow = out_hw
    sh, sw = src_hw
    t = theta
    a11 = t[:, 0, 0] * (sw / ow)
    a12 = t[:, 0, 1] * (sw / oh)
    a21 = t[:, 1, 0] * (sh / ow)
    a22 = t[:, 1, 1] * (sh / oh)
    xn0 = 1.0 / ow - 1.0
    yn0 = 1.0 / oh - 1.0
    xs0 = t[:, 0, 0] * xn0 + t[:, 0, 1] * yn0 + t[:, 0, 2]
    ys0 = t[:, 1, 0] * xn0 + t[:, 1, 1] * yn0 + t[:, 1, 2]
    b1 = ((xs0 + 1.0) * sw - 1.0) * 0.5 - offset[1]
    b2 = ((ys0 + 1.0) * sh - 1.0) * 0.5 - offset[0]
    return a11, a12, a21, a22, b1, b2


def output_grid_coords(out_hw: Tuple[int, int], dtype=torch.float32,
                       device="cpu"):
    """Normalized align_corners=False output coords: x_n [ow], y_n [oh].
    The divisor is a 0-dim tensor on ``device``: on CUDA a division by a
    Python scalar is a multiplication by its reciprocal, an ulp off the
    division that XLA (and the CPU) makes."""
    def coords(n):
        i = torch.arange(n, dtype=dtype, device=device)
        return (2.0 * i + 1.0) / torch.full((), n, dtype=dtype,
                                            device=device) - 1.0
    return coords(out_hw[1]), coords(out_hw[0])


def affine_source_coords(theta: torch.Tensor, out_hw: Tuple[int, int],
                         src_hw: Tuple[int, int]):
    """Source *pixel* coords (ix, iy), each [B, oh, ow], for a batch of
    2x3 affines ``theta`` [B, 2, 3] in normalized-coordinate convention."""
    sh, sw = src_hw
    x_n, y_n = output_grid_coords(out_hw, theta.dtype, theta.device)
    xg = x_n[None, None, :]
    yg = y_n[None, :, None]
    t = theta[:, :, :, None, None]
    xs = t[:, 0, 0] * xg + t[:, 0, 1] * yg + t[:, 0, 2]
    ys = t[:, 1, 0] * xg + t[:, 1, 1] * yg + t[:, 1, 2]
    ix = ((xs + 1.0) * sw - 1.0) * 0.5
    iy = ((ys + 1.0) * sh - 1.0) * 0.5
    return ix, iy


def bilinear_gather(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                    with_mask: bool = False):
    """Bilinear-sample ``img`` [B, H, W, C] at pixel coords ``ix, iy``
    [B, oh, ow] with zero padding: [B, oh, ow, C] (and the in-bounds
    bilinear weight-sum mask [B, oh, ow, 1]). The JAX package's
    ``bilinear_gather`` op for op (four taps, each weighted and summed in
    that order, in float32), so on equal coordinates it gives its values
    bit for bit on the CPU and on the card; the eval placement tests its
    mask for exactly 1.0."""
    b, h, w, c = img.shape
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    fx = ix - ix0
    fy = iy - iy0
    ix0 = ix0.long()
    iy0 = iy0.long()
    ix1 = ix0 + 1
    iy1 = iy0 + 1
    flat = img.reshape(b, h * w, c)

    def tap(iyk, ixk, wk):
        valid = (ixk >= 0) & (ixk < w) & (iyk >= 0) & (iyk < h)
        idx = (iyk.clamp(0, h - 1) * w + ixk.clamp(0, w - 1)).reshape(b, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        wv = (wk * valid).to(img.dtype)
        return vals.reshape(*ixk.shape, c) * wv[..., None], wv

    v00, m00 = tap(iy0, ix0, (1 - fx) * (1 - fy))
    v01, m01 = tap(iy0, ix1, fx * (1 - fy))
    v10, m10 = tap(iy1, ix0, (1 - fx) * fy)
    v11, m11 = tap(iy1, ix1, fx * fy)
    out = v00 + v01 + v10 + v11
    if with_mask:
        return out, (m00 + m01 + m10 + m11)[..., None]
    return out


def affine_sample(img: torch.Tensor, theta: torch.Tensor,
                  out_hw: Tuple[int, int],
                  src_hw: Optional[Tuple[int, int]] = None,
                  offset: Tuple[float, float] = (0.0, 0.0),
                  with_mask: bool = False):
    """Warp ``img`` [B, H, W, C] by per-sample inverse affines ``theta``
    [B, 2, 3] -> [B, oh, ow, C] (and the mask [B, oh, ow, 1]).

    ``src_hw`` is the virtual source-space size theta's normalized coords
    refer to (default img's H, W); ``offset = (off_y, off_x)`` shifts
    source pixel coords before indexing ``img``."""
    b, h, w, c = img.shape
    if src_hw is None:
        src_hw = (h, w)
    ix, iy = affine_source_coords(theta.detach(), out_hw, src_hw)
    ix = ix - offset[1]
    iy = iy - offset[0]
    # non-finite coords (a degenerate zoom) sample nothing
    ix = torch.where(torch.isfinite(ix), ix, torch.full_like(ix, -1e6))
    iy = torch.where(torch.isfinite(iy), iy, torch.full_like(iy, -1e6))
    # pixel -> the patch's own normalized coords (align_corners=False)
    grid = torch.stack([(2.0 * ix + 1.0) / w - 1.0,
                        (2.0 * iy + 1.0) / h - 1.0], dim=-1)
    src = img.permute(0, 3, 1, 2)
    if with_mask:
        src = torch.cat([src, torch.ones_like(src[:, :1])], dim=1)
    out = F.grid_sample(src, grid.to(src.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    out = out.permute(0, 2, 3, 1)
    if with_mask:
        return out[..., :c], out[..., c:]
    return out
