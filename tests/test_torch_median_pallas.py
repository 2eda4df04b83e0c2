"""The rank-counting median (K7's plain version,
``experimental/median_pallas.py``) against the JAX package's Pallas
``median_pool_2d_pallas`` in interpret mode and its sort-path
``ops.median_pool_2d``, on the CPU.

Tolerance: none. The median is one of the inputs, so every element must
be equal bit for bit, ties, leading dims, odd sizes, an even k and a
bfloat16 input included; a window with more NaNs than its lower half
comes out as the Pallas kernel's ``-inf``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import ops as JO
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.experimental import median_pallas as JMP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.experimental import median_pallas as MP


def _input(shape, seed=0):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    x[..., 4:9, 6:11] = 0.5   # a tied block
    return x


@pytest.mark.parametrize("shape,k", [((3, 20, 24), 3), ((3, 20, 24), 7),
                                     ((2, 2, 13, 9), 3), ((1, 11, 15), 7),
                                     ((3, 10, 12), 4)])
def test_plain_matches_pallas_interpret_and_sort_path(shape, k):
    x = _input(shape)
    n = MP.median_pool_2d_pallas.launches
    got = MP.median_pool_2d_pallas(torch.from_numpy(x), k)
    assert MP.median_pool_2d_pallas.launches == n   # plain on the CPU
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    want = np.asarray(JMP.median_pool_2d_pallas(jnp.asarray(x), k,
                                                interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JO.median_pool_2d(jnp.asarray(x), k, 1)))


def test_bf16_input_rounds_back_exactly():
    x = _input((3, 16, 18), seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = MP.median_pool_2d_pallas(xb, 7)
    assert got.dtype == torch.bfloat16
    want = JMP.median_pool_2d_pallas(jnp.asarray(xb.float().numpy(),
                                                 jnp.bfloat16), 7,
                                     interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_nan_window_gives_minus_inf_as_pallas():
    x = _input((2, 20, 24), seed=2)
    x[0, 5:12, 5:12] = np.nan        # windows with > 24 NaNs of 49
    x[1, 3, 3] = np.nan              # a lone NaN: ignored by the ranks
    got = MP.median_pool_2d_pallas(torch.from_numpy(x), 7).numpy()
    want = np.asarray(JMP.median_pool_2d_pallas(jnp.asarray(x), 7,
                                                interpret=True))
    assert np.isneginf(want).sum() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,k", [(3, 10, 7), (10, 1, 3), (5, 5, 0)])
def test_refuses_windows_reflection_cannot_fill(h, w, k):
    with pytest.raises(ValueError, match="k // 2"):
        MP.median_pool_2d_pallas(torch.zeros(2, h, w), k)


@pytest.mark.parametrize("k", [3, 4, 7])
def test_signed_zeros_and_inf_equal_pallas_bit_for_bit(k):
    """+0 and -0 mixes and real +-inf: the last qualifying zero in window
    order decides the sign, as in the Pallas kernel; compared on int32
    views, where -0 and +0 differ."""
    rng = np.random.default_rng(40 + k)
    x = _input((2, 14, 16), seed=k)
    x[0, 2:10, 3:12] = np.where(rng.random((8, 9)) < 0.5, -0.0, 0.0)
    x[0, 11, 4:9] = np.inf
    x[1] = np.where(rng.random((14, 16)) < 0.5, -0.0, 0.0)
    x[1, 1:9, 1:9] = np.inf
    x[1, 9:13, 10:14] = -np.inf
    got = MP.median_pool_2d_pallas(torch.from_numpy(x), k).numpy()
    want = np.asarray(JMP.median_pool_2d_pallas(jnp.asarray(x), k,
                                                interpret=True))
    assert np.signbit(want[want == 0]).any() and (
        ~np.signbit(want[want == 0])).any()
    assert np.isposinf(want).any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
