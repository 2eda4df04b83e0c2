"""K7's network form (``csrc/median_pool.cu``, k <= 8) emulated in torch
on the CPU, per pixel as the kernel runs it: NaN staged as +inf, the
pruned network of ``median_net_table(k)`` (the table that
``csrc/median_net.cuh`` is generated from; each comparator computes only
the halves it is marked with), then the two settling passes
(a +inf result becomes -inf when the window's NaNs reach n - (n-1)//2; a
zero result takes the last zero in window order). It must equal K7's
plain version, the rank counter, bit for bit.

Tolerance: none, on int32 (bfloat16: int16) views, so +0 and -0 and every
NaN and infinity count. The inputs carry tied blocks, +-0 mixes, real
+inf and -inf, lone NaNs, windows with exactly n - (n-1)//2 - 1 and
n - (n-1)//2 NaNs (one of the former with a real +inf), and a field drawn
from a few values, zeros of both signs and NaN among them."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.experimental import median_pallas as MPL
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import median_pool as MP

INF = float("inf")


def network_form(x: torch.Tensor, k: int) -> torch.Tensor:
    """What each thread of K7's network form computes, for all pixels."""
    *lead, h, w = x.shape
    pt, pb, pl, pr = MPL._pads(h, w, k)
    xp = F.pad(x.float().reshape(-1, h, w), (pl, pr, pt, pb), mode="reflect")
    wins = [xp[:, di:di + h, dj:dj + w] for di in range(k) for dj in range(k)]
    v = [torch.where(t.isnan(), INF, t) for t in wins]
    pairs, out = MP.median_net_table(k)
    for a, b, side in pairs:      # only the halves the median reads
        lo, hi = torch.minimum(v[a], v[b]), torch.maximum(v[a], v[b])
        if side != "max":
            v[a] = lo
        if side != "min":
            v[b] = hi
    med = v[out]
    n = k * k
    nans = sum(t.isnan().to(torch.int32) for t in wins)
    med = torch.where((med == INF) & (nans >= n - (n - 1) // 2), -INF, med)
    zero = med == 0
    for t in wins:
        med = torch.where(zero & (t == 0), t, med)
    return med.reshape(*lead, h, w).to(x.dtype)


def _field(k, seed):
    """[5, 24, 26] float32: see the module docstring, one case a channel."""
    n = k * k
    limit = n - (n - 1) // 2          # NaNs that leave no rank-(n-1)//2 value
    rng = np.random.default_rng(seed)
    x = rng.random((5, 24, 26)).astype(np.float32)
    x[0, 3:9, 4:12] = 0.5                               # tied block
    x[0, 12:18, 2:9] = np.where(rng.random((6, 7)) < 0.5, -0.0, 0.0)
    x[0, 14, 14:20] = np.inf
    x[0, 20, 3:8] = -np.inf
    x[0, 2, 20] = x[0, 17, 23] = np.nan                 # lone NaNs
    pt = (k - 1) // 2
    for ch, count in ((1, limit - 1), (2, limit)):
        win = x[ch, 10 - pt:10 - pt + k, 12 - pt:12 - pt + k].reshape(-1)
        win[:count] = np.nan
        x[ch, 10 - pt:10 - pt + k, 12 - pt:12 - pt + k] = win.reshape(k, k)
    x[1, 10 - pt + k - 1, 12 - pt + k - 1] = np.inf     # a real +inf too
    vals = np.float32([-0.0, 0.0, 0.0, 1.0, -1.0, np.inf, -np.inf, np.nan])
    x[3] = rng.choice(vals, (24, 26), p=[.2, .2, .1, .15, .15, .06, .06, .08])
    x[4] = np.where(rng.random((24, 26)) < 0.5, -0.0, 0.0)
    x[4, 5:9, 5:9] = 0.25
    return x


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", range(1, 9))
def test_network_form_equals_rank_counter_bit_for_bit(k, dtype):
    x = torch.from_numpy(_field(k, seed=30 + k)).to(dtype)
    got = network_form(x, k)
    want = MPL.median_pool_2d_pallas_plain(x, k)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    # the cases are there: -inf windows, a -0 and a +0 median, NaN nowhere
    wf = want.float()
    assert bool(wf[2].isneginf().any()) and not bool(wf[1].isneginf().any())
    assert bool((wf == 0).logical_and(wf.signbit()).any())
    assert bool((wf == 0).logical_and(~wf.signbit()).any())
    assert not bool(wf.isnan().any())


@pytest.mark.parametrize("k", [1, 4, 7])
def test_network_form_on_leading_dims_and_odd_sizes(k):
    x = np.random.default_rng(k).random((2, 3, 9, 13)).astype(np.float32)
    x[0, 1, 2:5, 3:9] = -0.0
    x[1, 2, 4, 4] = np.nan
    x = torch.from_numpy(x)
    assert torch.equal(_bits(network_form(x, k)),
                       _bits(MPL.median_pool_2d_pallas_plain(x, k)))


@pytest.mark.parametrize("case", ["ties", "zeros", "nan"])
@pytest.mark.parametrize("shape,k", [((3, 40, 37), 7), ((2, 2, 17, 33), 3),
                                     ((1, 9, 5), 8), ((2, 19, 41), 1),
                                     ((2, 19, 41), 4)])
def test_network_form_on_the_card_checks_inputs(shape, k, case):
    """``median_pallas.check_input``, the inputs that the GPU tests and
    ``chip_smoke.py`` hold K7 to: the emulated network form equals the
    rank counter bit for bit on them, and a "nan" input has windows with
    exactly n - (n-1)//2 - 1 and n - (n-1)//2 NaNs."""
    x = torch.from_numpy(MPL.check_input(shape, k, case, seed=15 + k))
    assert x.shape == shape and x.dtype == torch.float32
    assert torch.equal(_bits(network_form(x, k)),
                       _bits(MPL.median_pool_2d_pallas_plain(x, k)))
    if case == "nan":
        n = k * k
        counts = MPL.window_nans(x, k)
        assert bool((counts == n - (n - 1) // 2 - 1).any())
        assert bool((counts == n - (n - 1) // 2).any())
