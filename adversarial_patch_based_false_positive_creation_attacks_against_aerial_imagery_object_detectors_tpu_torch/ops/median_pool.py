"""Differentiable median filter (the EOT stack's patch smoother).

The JAX package's ``ops/median_pool.py``: reflect padding by the "same"
rule, k x k windows, and the *lower* median of each window (the reference
MedianPool2d's ``torch.median``). ``median_pool_2d`` is the sort path;
``median_pool_nhwc_fast`` (stride 1) is the training path, a
``torch.autograd.Function`` whose backward routes each output's cotangent
to the tied occurrence the stable sort picks, the
``((n-1)//2 - #less + 1)``-th equal element in window order, and folds
the padding back, exactly as the JAX package's custom VJP does. The
median value comes from ``torch.kthvalue``, whose value is unique; its
index, like ``torch.median``'s, is not used (its tie choice is
unspecified and differs between CPU and CUDA).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _same_pad_amounts(size: int, k: int, stride: int):
    if size % stride == 0:
        p = max(k - stride, 0)
    else:
        p = max(k - (size % stride), 0)
    lo = p // 2
    return lo, p - lo


def _reflect_pad(x: torch.Tensor, k: int, stride: int):
    """Reflect-pad the last two dims of ``x`` [..., H, W] by the same
    rule; returns (padded, (pt, pb, pl, pr))."""
    *lead, h, w = x.shape
    pt, pb = _same_pad_amounts(h, k, stride)
    pl, pr = _same_pad_amounts(w, k, stride)
    x3 = x.reshape(-1, h, w)
    xp = F.pad(x3, (pl, pr, pt, pb), mode="reflect")
    return xp.reshape(*lead, h + pt + pb, w + pl + pr), (pt, pb, pl, pr)


def median_pool_2d(x: torch.Tensor, k: int = 7,
                   stride: int = 1) -> torch.Tensor:
    """Lower median over k x k windows of the last two dims of ``x``
    ([..., H, W]); the sort path."""
    h, w = x.shape[-2:]
    xp, (pt, pb, pl, pr) = _reflect_pad(x, k, stride)
    oh = (h + pt + pb - k) // stride + 1
    ow = (w + pl + pr - k) // stride + 1
    windows = [xp[..., di:di + (oh - 1) * stride + 1:stride,
                  dj:dj + (ow - 1) * stride + 1:stride]
               for di in range(k) for dj in range(k)]
    stack = torch.stack(windows, dim=0)
    return torch.sort(stack, dim=0, stable=True).values[(k * k - 1) // 2]


def _windows(xp: torch.Tensor, k: int, h: int, w: int):
    return [xp[..., di:di + h, dj:dj + w]
            for di in range(k) for dj in range(k)]


def _reflect_fold(dpad: torch.Tensor, h: int, w: int, pt: int, pb: int,
                  pl: int, pr: int) -> torch.Tensor:
    """Adjoint of reflect padding: fold border cotangents back inside
    (the JAX package's order of additions)."""
    rows = dpad[..., pt:pt + h, :].clone()
    if pt:
        rows[..., 1:pt + 1, :] += torch.flip(dpad[..., :pt, :], (-2,))
    if pb:
        rows[..., h - 1 - pb:h - 1, :] += torch.flip(dpad[..., pt + h:, :],
                                                     (-2,))
    out = rows[..., :, pl:pl + w].clone()
    if pl:
        out[..., :, 1:pl + 1] += torch.flip(rows[..., :, :pl], (-1,))
    if pr:
        out[..., :, w - 1 - pr:w - 1] += torch.flip(rows[..., :, pl + w:],
                                                    (-1,))
    return out


class MedianPool2d(torch.autograd.Function):
    """Stride-1 lower median of ``x`` [..., H, W] with the stable sort's
    subgradient."""

    @staticmethod
    def forward(ctx, x, k):
        h, w = x.shape[-2:]
        xp, _ = _reflect_pad(x, k, 1)
        stack = torch.stack(_windows(xp, k, h, w), dim=0)
        med = torch.kthvalue(stack, (k * k - 1) // 2 + 1, dim=0).values
        ctx.save_for_backward(x, med)
        ctx.k = k
        return med

    @staticmethod
    def backward(ctx, g):
        x, med = ctx.saved_tensors
        k = ctx.k
        h, w = x.shape[-2:]
        xp, (pt, pb, pl, pr) = _reflect_pad(x, k, 1)
        wins = _windows(xp, k, h, w)
        n_mid = (k * k - 1) // 2
        less = sum((wv < med).to(torch.int32) for wv in wins)
        target = n_mid - less + 1       # 1-based tied-occurrence rank
        csum = torch.zeros_like(less)
        dpad = torch.zeros(xp.shape, dtype=x.dtype, device=x.device)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        for idx, wv in enumerate(wins):
            di, dj = divmod(idx, k)
            eq = wv == med
            csum = csum + eq.to(torch.int32)
            sel = eq & (csum == target)
            dpad[..., di:di + h, dj:dj + w] += torch.where(sel, g, zero)
        return _reflect_fold(dpad, h, w, pt, pb, pl, pr), None


def median_pool_2d_fast(x: torch.Tensor, k: int = 7) -> torch.Tensor:
    return MedianPool2d.apply(x, k)


def median_pool_nhwc_fast(x: torch.Tensor, k: int = 7) -> torch.Tensor:
    """``median_pool_2d_fast`` over H, W of an NHWC (or HWC) tensor."""
    out = median_pool_2d_fast(torch.movedim(x, -1, -3), k)
    return torch.movedim(out, -3, -1)
