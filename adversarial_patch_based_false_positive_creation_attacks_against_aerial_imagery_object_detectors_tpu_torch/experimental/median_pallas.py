"""k x k median filter by rank selection (K7), the JAX package's
``experimental/median_pallas.py``.

The median value of each stride-1 "same" reflect-padded window is the
window element whose rank satisfies ``count_less <= (n-1)//2 < count_less
+ count_eq`` (the element a stable sort places at the lower-median index,
ties included). Where no element qualifies, which happens only with NaNs
in the window, the value is ``-inf``. Leading dims are flattened, the
compute is float32 and the result is cast back to ``x``'s dtype.

``median_pool_2d_pallas`` launches the hand-written kernel
(``csrc/median_pool.cu``: the tile staged in shared memory with the
reflection applied at load, then one thread per pixel; for k <= 8 the
pruned selection network of ``csrc/median_net.cuh`` on the window held in
registers, for k >= 9 rank counting) on a CUDA tensor and runs
``median_pool_2d_pallas_plain``, which counts ranks (not
``torch.kthvalue``, so that NaN windows come out as the kernel's), on a
CPU tensor. Both forms equal the plain version bit for bit. Not wired
into any path: the EOT smoother's forward is ``ops/median_pool.py``.
``check_input`` makes the inputs that the checks on the card hold the
kernel to.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops.median_pool import NET_KS, _same_pad_amounts


def _pads(h: int, w: int, k: int):
    """(top, bottom, left, right) reflect padding; reflection needs each
    side's pad below the size, i.e. H, W > k // 2."""
    if k < 1 or h <= k // 2 or w <= k // 2:
        raise ValueError(f"median_pool_2d_pallas: k={k} needs H, W > k // 2, "
                         f"got {h} x {w}")
    return (*_same_pad_amounts(h, k, 1), *_same_pad_amounts(w, k, 1))


def median_pool_2d_pallas_plain(x: torch.Tensor, k: int = 7) -> torch.Tensor:
    """K7's plain version: the rank-counting median of every k x k window
    of ``x`` [..., H, W] (float32 compute, ``x``'s dtype out)."""
    *lead, h, w = x.shape
    pt, pb, pl, pr = _pads(h, w, k)
    xp = F.pad(x.float().reshape(-1, h, w), (pl, pr, pt, pb), mode="reflect")
    wins = torch.stack([xp[:, di:di + h, dj:dj + w]
                        for di in range(k) for dj in range(k)])
    mid = (k * k - 1) // 2
    med = torch.full(wins.shape[1:], float("-inf"), device=x.device)
    for wk in wins:
        less = (wins < wk).sum(0)
        eq = (wins == wk).sum(0)
        med = torch.where((less <= mid) & (less + eq > mid), wk, med)
    return med.reshape(*lead, h, w).to(x.dtype)


def kernel_form(k: int) -> str:
    """The form of K7 that a window of side ``k`` launches: "network"
    (the selection network, k <= 8) or "rank" (rank counting)."""
    return "network" if k in NET_KS else "rank"


def median_pool_2d_pallas(x: torch.Tensor, k: int = 7) -> torch.Tensor:
    """Stride-1 "same" median pool of ``x`` [..., H, W]: the K7 kernel on a
    contiguous float32 or bfloat16 CUDA tensor (every launch counted in
    ``median_pool_2d_pallas.launches``, those of the network form also in
    ``.network_launches``), the plain version on a CPU tensor; anything
    else raises."""
    if x.device.type == "cpu":
        return median_pool_2d_pallas_plain(x, k)
    return _median_pool_into(x, None, k)


def _median_pool_into(x: torch.Tensor, out: Optional[torch.Tensor],
                      k: int = 7) -> torch.Tensor:
    """``median_pool_2d_pallas``' launch, into ``out`` when it is given: a
    contiguous block of ``x``'s shape, dtype and device (the GPU checks
    pass one filled with NaN, so a pixel the kernel fails to write
    shows)."""
    _cuda.require_cuda("median_pool_2d_pallas", x)
    *_, h, w = x.shape
    pt, _, pl, _ = _pads(h, w, k)
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"median_pool_2d_pallas: out must be a contiguous "
                         f"{x.dtype} {tuple(x.shape)} block on {x.device}")
    c = x.numel() // (h * w)
    if c == 0:
        return out
    _cuda.launch("median_pool_2d_pallas", "median_pool", "apfp_median_pool",
                 x, x.data_ptr(), out.data_ptr(), _cuda.DTYPE_CODES[x.dtype],
                 c, h, w, k, pt, pl)
    median_pool_2d_pallas.launches += 1
    if kernel_form(k) == "network":
        median_pool_2d_pallas.network_launches += 1
    return out


median_pool_2d_pallas.launches = 0
median_pool_2d_pallas.network_launches = 0


def window_nans(x: torch.Tensor, k: int) -> torch.Tensor:
    """The NaNs in each pixel's reflect-padded k x k window of ``x``
    [..., H, W], as [C, H * W] int32 (C the leading dims flattened)."""
    h, w = x.shape[-2:]
    pt, pb, pl, pr = _pads(h, w, k)
    xp = F.pad(x.isnan().float().reshape(-1, 1, h, w), (pl, pr, pt, pb),
               mode="reflect")
    return F.unfold(xp, k).sum(1).round().int()


def check_input(shape, k: int, case: str, seed: int) -> np.ndarray:
    """A float32 input of ``shape`` for K7's checks: "ties" (a tied block,
    a lone NaN), "zeros" (+0 and -0 mixed, a corner of random values, a
    quadrant of +inf and a column of -inf), "nan" (NaN at a density around
    the -inf limit of n - (n-1)//2 NaNs a window, one tenth +inf; drawn
    with seed, seed + 1, ... until windows hold exactly limit - 1 and
    exactly limit NaNs)."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    v = x.reshape(-1, *shape[-2:])
    h, w = shape[-2:]
    n = k * k
    limit = n - (n - 1) // 2
    if case == "ties":
        v[:, 2:7, 1:4] = 0.5
        v[:, 0, 0] = np.nan
    elif case == "zeros":
        v[:] = np.where(rng.random(v.shape) < 0.5, -0.0, 0.0)
        v[:, :h // 3, :w // 3] = rng.random((v.shape[0], h // 3, w // 3))
        v[:, h // 2:, w // 2:] = np.inf
        v[:, :, w // 4] = -np.inf
    elif case == "nan":
        u = rng.random(v.shape)
        v[u < 0.1] = np.inf
        v[u > 1 - (limit - 0.5) / n - np.linspace(-0.15, 0.15, w)] = np.nan
        counts = window_nans(torch.from_numpy(x), k)
        if not ((counts == limit - 1).any() and (counts == limit).any()):
            if seed >= 1000:
                raise ValueError(f"check_input: no seed up to 1000 gives "
                                 f"{shape} k {k} both NaN counts")
            return check_input(shape, k, case, seed + 1)
    else:
        raise ValueError(f"check_input: unknown case {case!r}")
    return x
