"""Differentiable median filter (the EOT stack's patch smoother).

The JAX package's ``ops/median_pool.py``: reflect padding by the "same"
rule, k x k windows, and the *lower* median of each window (the reference
MedianPool2d's ``torch.median``). ``median_pool_2d`` is the sort path
(``median_pool_nhwc`` over an NHWC tensor); ``median_select`` is the JAX
package's min/max selection network over a list of windows, and
``median_net_table`` the same network pruned for one k (each
comparator with the halves the median reads), from which
``csrc/median_net.cuh`` (K7's network form) is generated;
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


def median_pool_nhwc(x: torch.Tensor, k: int = 7,
                     stride: int = 1) -> torch.Tensor:
    """``median_pool_2d`` over H, W of an NHWC (or HWC) tensor."""
    out = median_pool_2d(torch.movedim(x, -1, -3), k, stride)
    return torch.movedim(out, -3, -1)


def _batcher_pairs(n: int):
    """Comparator pairs of Batcher's odd-even merge sort for ``n`` a
    power of two (classic iterative formulation)."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (p * 2) == (i + j + k) // (p * 2):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def median_select(windows: list) -> torch.Tensor:
    """Lower median of a list of same-shaped tensors by the JAX
    package's Batcher min/max network: the list padded with +inf to the
    next power of two (the padding only shifts ranks above the median) and
    the whole sorting network applied. NaN propagates as through
    ``torch.minimum``; the sign of a zero median may differ from the JAX
    package's, whose minimum orders -0 below +0."""
    n = len(windows)
    m = 1
    while m < n:
        m *= 2
    vals = list(windows) + [torch.full_like(windows[0], float("inf"))] * (
        m - n)
    for i, j in _batcher_pairs(m):
        a, b = vals[i], vals[j]
        vals[i] = torch.minimum(a, b)
        vals[j] = torch.maximum(a, b)
    return vals[(n - 1) // 2]


def median_net_table(k: int):
    """The comparators of ``median_select`` for the n = k * k values of a
    k x k window that output (n-1)//2 needs: ``(pairs, out)``, where each
    pair (a, b, side) puts the minimum of values a and b in a (side "min"
    or "both") and the maximum in b (side "max" or "both"), and value
    ``out`` is the lower median after the last pair. A half that the
    median never reads is marked away: "min" leaves b as it was, "max"
    leaves a.

    The +inf padding is folded away first: a comparator whose larger
    input slot holds padding leaves both slots as they are, and one whose
    smaller slot does moves the other slot's value into it. Then only the
    comparators in the backward cone of output (n-1)//2 are kept, each
    with the sides whose results are read later. Values are numbered in
    window order, row by row."""
    n = k * k
    m = 1
    while m < n:
        m *= 2
    slot = list(range(n)) + [None] * (m - n)     # None: +inf padding
    live = []
    for i, j in _batcher_pairs(m):
        a, b = slot[i], slot[j]
        if b is None:
            continue
        if a is None:
            slot[i], slot[j] = b, None
            continue
        live.append((a, b))
    out = slot[(n - 1) // 2]
    need, kept = {out}, []
    for a, b in reversed(live):
        if a in need or b in need:
            side = ("both" if a in need and b in need
                    else "min" if a in need else "max")
            kept.append((a, b, side))
            need.update((a, b))
    return tuple(reversed(kept)), out


def median_net_minmax(k: int) -> int:
    """The min/max instructions of ``median_net_table(k)`` an output: one
    for each side that the median reads."""
    return sum(2 if side == "both" else 1
               for _, _, side in median_net_table(k)[0])


NET_KS = tuple(range(1, 9))   # the k that K7's network form instantiates


def median_net_header() -> str:
    """The text of ``csrc/median_net.cuh``: ``median_net_table(k)`` for
    each k of ``NET_KS`` as CUDA code with literal indices."""
    lines = [
        "// The pruned median-selection networks of K7's network form",
        "// (median_pool.cu), k = 1..8. Generated from the port's",
        "// ops/median_pool.py: median_net_table(k); rewrite it with",
        "//     python -m <port package>.ops.median_pool",
        "// and do not edit it by hand.",
        "//",
        "// v[0 .. n-1] holds the n = k * k values of a k x k window in window",
        "// order, row by row. The comparators are those of Batcher's odd-even",
        "// merge sort of the next power of two, with the +inf padding folded",
        "// away and only output (n - 1) / 2's backward cone kept.",
        "// median_ce(v[a], v[b]) leaves the minimum in v[a] and the maximum in",
        "// v[b]; median_lo and median_hi compute only the half that the median",
        "// reads (the minimum into v[a], the maximum into v[b]). After",
        "// median_net<K>::run(v), v[median_net<K>::out] is the lower median.",
        "// Every index is a literal, so v lives in registers.",
        "",
        "#pragma once",
        "",
        "__device__ __forceinline__ void median_ce(float& a, float& b) {",
        "  const float lo = fminf(a, b);",
        "  b = fmaxf(a, b);",
        "  a = lo;",
        "}",
        "__device__ __forceinline__ void median_lo(float& a, float b) {",
        "  a = fminf(a, b);",
        "}",
        "__device__ __forceinline__ void median_hi(float a, float& b) {",
        "  b = fmaxf(a, b);",
        "}",
        "",
        "template <int K>",
        "struct median_net;",
    ]
    fn = {"both": "median_ce", "min": "median_lo", "max": "median_hi"}
    for k in NET_KS:
        pairs, out = median_net_table(k)
        n = k * k
        lines += ["", "template <>", f"struct median_net<{k}> {{",
                  f"  static constexpr int n = {n}, out = {out}, "
                  f"comparators = {len(pairs)}, "
                  f"minmax = {median_net_minmax(k)};",
                  "  static __device__ __forceinline__ void run("
                  f"float (&{'v' if pairs else ''})[{n}]) {{"]
        calls = [f"{fn[side]}(v[{a}], v[{b}]);" for a, b, side in pairs]
        row = "   "
        for c in calls:
            if len(row) + 1 + len(c) > 79:
                lines.append(row)
                row = "   "
            row += " " + c
        if calls:
            lines.append(row)
        lines += ["  }", "};"]
    return "\n".join(lines) + "\n"


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


if __name__ == "__main__":
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "csrc", "median_net.cuh")
    with open(path, "w") as f:
        f.write(median_net_header())
    print(f"wrote {path}")
