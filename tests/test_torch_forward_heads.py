"""``Detector.forward_heads`` of the port against the JAX package's, each
Detector at its default compute dtype (bfloat16 for both): the JAX
package's runs ``darknet.apply`` at its float32 default, so the port's
must return float32 heads computed in float32 whatever its own dtype.

Tolerance: 1e-5 of each head's scale. Both sides run the same float32
convolutions, summed in different orders (XLA's and PyTorch's CPU
kernels)."""

import jax
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import evals as JE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import models as JM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import evals as PE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM


@pytest.fixture(scope="module")
def detectors():
    """(JAX Detector, port Detector on the CPU, images), both at their
    default compute dtype."""
    net = JM.build_network(JM.tiny_test_blocks())
    params = JM.fold_bn(net, JM.init_params(net, jax.random.PRNGKey(5)))
    pnet = PM.build_network(PM.tiny_test_blocks())
    jdet = JE.Detector(net, params, img_size=64)
    pdet = PE.Detector(pnet, PM.params_from_jax(params), img_size=64,
                       device="cpu")
    assert pdet.compute_dtype == torch.bfloat16
    images = np.random.default_rng(0).random((2, 64, 64, 3))
    return jdet, pdet, images


def test_forward_heads_float32_matches_jax(detectors):
    jdet, pdet, images = detectors
    want = [np.asarray(h) for h in jdet.forward_heads(images)]
    got = pdet.forward_heads(images)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == w.shape
        scale = np.abs(w).max()
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * scale, (err, scale)


def test_forward_heads_ignore_the_compute_dtype(detectors):
    """A float32 Detector on the same weights returns the same heads, and
    the bfloat16 Detector's serving path keeps its own dtype."""
    _, pdet, images = detectors
    det32 = PE.Detector(pdet.net, pdet.params, img_size=64,
                        compute_dtype=torch.float32, device="cpu")
    for a, b in zip(pdet.forward_heads(images), det32.forward_heads(images)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert pdet.model.compute_dtype == torch.bfloat16
