"""The port's median selection network (``ops/median_pool.py``:
``median_select``, ``median_pool_nhwc``) against the JAX package's, and
the pruned network tables (``median_net_table``) that K7's network form
is generated from (``csrc/median_net.cuh``), on the CPU.

Tolerance: none. A median is one of its inputs, so values must be equal
(NaN where NaN); the two frameworks' minimum orders -0 and +0 differently,
so the inputs here hold no zeros and a zero's sign is K7's emulation's
test (``test_torch_median_kernel_algorithm.py``)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import ops as JO
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import median_pool as JMP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import ops as PO
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import median_pool as MP


def _windows(n, shape, seed):
    """n windows of ``shape`` from (0.25, 1), a tied patch, and one +inf,
    one -inf and one NaN."""
    w = np.random.default_rng(seed).uniform(0.25, 1.0, (n, *shape))
    w = w.astype(np.float32)
    w[:, :2, :3] = 0.5
    w[0, 2, 0] = np.inf
    w[n // 2, 2, 1] = -np.inf
    w[n - 1, 3, 0] = np.nan
    return w


@pytest.mark.parametrize("n", [1, 5, 9, 16, 25, 49, 64, 81])
def test_median_select_equals_jax(n):
    w = _windows(n, (6, 7), seed=n)
    got = MP.median_select([torch.from_numpy(a) for a in w]).numpy()
    want = np.asarray(JMP.median_select([jnp.asarray(a) for a in w]))
    np.testing.assert_array_equal(got, want)
    # the lower median of every column that holds no NaN
    lower = np.sort(w, axis=0)[(n - 1) // 2]
    ok = ~np.isnan(w).any(axis=0)
    np.testing.assert_array_equal(got[ok], lower[ok])


@pytest.mark.parametrize("shape,k,stride", [((2, 12, 10, 3), 3, 1),
                                            ((13, 9, 3), 7, 1),
                                            ((2, 12, 10, 3), 4, 2),
                                            ((1, 15, 11, 2), 5, 3)])
def test_median_pool_nhwc_equals_jax(shape, k, stride):
    x = np.random.default_rng(k).uniform(0.25, 1.0, shape).astype(np.float32)
    x[..., 3:7, 2:5, :] = 0.75
    got = PO.median_pool_nhwc(torch.from_numpy(x), k, stride).numpy()
    want = np.asarray(JO.median_pool_nhwc(jnp.asarray(x), k, stride))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ops_exports_the_jax_median_names():
    for name in ("median_pool_2d", "median_pool_nhwc", "median_pool_2d_fast",
                 "median_pool_nhwc_fast", "median_select"):
        assert hasattr(JO, name)
        assert getattr(PO, name) is getattr(MP, name)


def test_committed_header_equals_its_regeneration():
    path = os.path.join(os.path.dirname(MP.__file__), os.pardir, "csrc",
                        "median_net.cuh")
    with open(path) as f:
        assert f.read() == MP.median_net_header()


# live comparators an output: Batcher's network of the next power of two,
# +inf padding folded away, output (n-1)//2's backward cone kept; and the
# min/max instructions of those comparators' halves that the median reads
LIVE = {1: 0, 2: 5, 3: 24, 4: 53, 5: 113, 6: 214, 7: 319, 8: 445, 9: 702}
MINMAX = {1: 0, 2: 7, 3: 40, 4: 91, 5: 202, 6: 393, 7: 590, 8: 827, 9: 1324}


@pytest.mark.parametrize("k", sorted(LIVE))
def test_median_net_table_counts_and_selects(k):
    """The pruned table has the counted comparators and min/max halves,
    touches only the n window values, and, computing only the marked
    halves, leaves the lower median at ``out`` on random columns with ties
    and infinities."""
    pairs, out = MP.median_net_table(k)
    n = k * k
    assert len(pairs) == LIVE[k]
    assert MP.median_net_minmax(k) == MINMAX[k]
    assert 0 <= out < n
    assert all(0 <= a < n and 0 <= b < n and a != b
               and side in ("both", "min", "max") for a, b, side in pairs)
    rng = np.random.default_rng(k)
    v = rng.choice(np.float32([-np.inf, -1, 0.25, 0.5, 2, np.inf]), (n, 500))
    v[:, :250] = rng.random((n, 250), np.float32)
    want = np.sort(v, axis=0)[(n - 1) // 2]
    for a, b, side in pairs:
        lo, hi = np.minimum(v[a], v[b]), np.maximum(v[a], v[b])
        if side != "max":
            v[a] = lo
        if side != "min":
            v[b] = hi
    np.testing.assert_array_equal(v[out], want)
