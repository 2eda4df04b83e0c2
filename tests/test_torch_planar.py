"""The planar layout conversions (K3a to_planar, K3b from_planar): the
port's plain versions against the JAX package's jnp versions and its
Pallas kernels in interpret mode. Layout moves are exact, so every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import planar_conv as JPC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import stem_fused as JSF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,c_pad", [((2, 5, 7, 3), None),
                                         ((2, 5, 7, 3), 8),
                                         ((1, 4, 130, 16), None),
                                         ((1, 3, 16, 128), None)])
def test_plain_layouts_match_jnp(shape, c_pad):
    x = _x(shape)
    want = np.asarray(JPC.to_planar(jnp.asarray(x), c_pad=c_pad))
    got = PC.to_planar_plain(torch.from_numpy(x), c_pad=c_pad)
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU wrapper is the plain version
    np.testing.assert_array_equal(
        PC.to_planar(torch.from_numpy(x), c_pad=c_pad).numpy(), want)
    c = shape[-1]
    back = np.asarray(JPC.from_planar(jnp.asarray(want), shape[2], c=c))
    np.testing.assert_array_equal(
        PC.from_planar_plain(got, shape[2], c).numpy(), back)
    np.testing.assert_array_equal(PC.from_planar(got, shape[2], c).numpy(), x)


@pytest.mark.parametrize("step,offset,c_pad", [(1, 0, None), (2, 0, 8),
                                               (2, 1, 8)])
def test_to_planar_matches_pallas_interpret(step, offset, c_pad):
    x = _x((2, 4, 16, 3), seed=1)
    want = np.asarray(JPC.to_planar_mxu(jnp.asarray(x), c_pad=c_pad,
                                        step=step, offset=offset,
                                        interpret=True))
    got = PC.to_planar_plain(torch.from_numpy(x), c_pad, step, offset)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_from_planar_matches_pallas_interpret():
    y = _x((2, 4, 16, 128), seed=2)
    yp = np.array(JPC.to_planar(jnp.asarray(y)))
    want = np.asarray(JPC.from_planar_mxu(jnp.asarray(yp), 16, 128,
                                          interpret=True))
    got = PC.from_planar_plain(torch.from_numpy(yp), 16, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, y)


def test_split_phases_match_jax_and_roundtrip():
    x = _x((2, 16, 16, 3), seed=3)
    je, jo = JSF.split_phases(jnp.asarray(x))
    pe, po = SF.split_phases(torch.from_numpy(x))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(SF.merge_phases(pe, po, 8, 3).numpy(), x)


def test_planar_bf16_is_exact():
    x = torch.from_numpy(_x((1, 4, 12, 5), seed=4)).to(torch.bfloat16)
    xp = PC.to_planar(x, c_pad=8)
    assert xp.dtype == torch.bfloat16 and xp.shape == (1, 4, 8, 128)
    assert torch.equal(PC.from_planar(xp, 12, 5), x)
    assert not xp[:, :, 5:].any() and not xp[..., 0].any()
    assert not xp[..., 13:].any()


# the kernels' edge geometries: odd W with the odd phase (one zero lane
# more than the even one), C on both sides of the narrow / tiled split,
# padding channels
@pytest.mark.parametrize("c", [31, 32, 33])
@pytest.mark.parametrize("step,offset", [(2, 1), (2, 0), (1, 0)])
def test_to_planar_edges_match_pallas_interpret(c, step, offset):
    x = _x((2, 3, 21, c), seed=c + offset)
    want = np.asarray(JPC.to_planar_mxu(jnp.asarray(x), c_pad=c + 7,
                                        step=step, offset=offset,
                                        interpret=True))
    got = PC.to_planar_plain(torch.from_numpy(x), c + 7, step, offset)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,cp,w_img", [(3, 8, 21), (31, 32, 13),
                                        (33, 40, 9)])
def test_from_planar_edges_match_pallas_interpret(c, cp, w_img):
    """c < cp on the way back, at odd widths."""
    yp = _x((2, 3, cp, 128), seed=cp + w_img)
    want = np.asarray(JPC.from_planar_mxu(jnp.asarray(yp), w_img, c,
                                          interpret=True))
    got = PC.from_planar_plain(torch.from_numpy(yp), w_img, c)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [21, 253])
def test_split_phases_odd_width_match_jax(w):
    """At odd W the even phase holds (W + 1) // 2 columns and the odd
    phase W // 2; at W = 253 their lane widths differ (256 and 128)."""
    x = _x((1, 2, w, 3), seed=w)
    je, jo = JSF.split_phases(jnp.asarray(x))
    pe, po = SF.split_phases(torch.from_numpy(x))
    assert pe.shape == je.shape and po.shape == jo.shape
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
