"""k x k median filter by rank selection (K7), the JAX package's
``experimental/median_pallas.py``.

The median value of each stride-1 "same" reflect-padded window is the
window element whose rank satisfies ``count_less <= (n-1)//2 < count_less
+ count_eq`` (the element a stable sort places at the lower-median index,
ties included). Where no element qualifies, which happens only with NaNs
in the window, the value is ``-inf``. Leading dims are flattened, the
compute is float32 and the result is cast back to ``x``'s dtype.

``median_pool_2d_pallas`` launches the hand-written kernel
(``csrc/median_pool.cu``: one thread per pixel, the tile staged in shared
memory with the reflection applied at load) on a CUDA tensor and runs
``median_pool_2d_pallas_plain``, which counts ranks too (not
``torch.kthvalue``, so that NaN windows come out as the kernel's), on a
CPU tensor. Not wired into any path: the EOT smoother's forward is
``ops/median_pool.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops.median_pool import _same_pad_amounts


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


def median_pool_2d_pallas(x: torch.Tensor, k: int = 7) -> torch.Tensor:
    """Stride-1 "same" median pool of ``x`` [..., H, W]: the K7 kernel on a
    contiguous float32 or bfloat16 CUDA tensor (counted in
    ``median_pool_2d_pallas.launches``), the plain version on a CPU
    tensor; anything else raises."""
    if x.device.type == "cpu":
        return median_pool_2d_pallas_plain(x, k)
    _cuda.require_cuda("median_pool_2d_pallas", x)
    *_, h, w = x.shape
    pt, _, pl, _ = _pads(h, w, k)
    out = torch.empty_like(x)
    c = x.numel() // (h * w)
    if c == 0:
        return out
    _cuda.launch("median_pool_2d_pallas", "median_pool", "apfp_median_pool",
                 x, x.data_ptr(), out.data_ptr(), _cuda.DTYPE_CODES[x.dtype],
                 c, h, w, k, pt, pl)
    median_pool_2d_pallas.launches += 1
    return out


median_pool_2d_pallas.launches = 0
