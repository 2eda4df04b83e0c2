"""The port's PGD fabrication attack (``attack/pgd.py``) against the JAX
package's, on the CPU, float32, on the tiny victim with shared weights:
the loss, one step's image gradient, and the adversarial images after
three steps.

Tolerances: the loss 1e-6; the gradient 1e-5 relative L2 (the two
frameworks' convs sum in different orders); the stepped images within
the eps box and [0, 1], and their share of pixels whose sign step went
the other way than JAX's <= 1e-3 (``sign`` turns rounding into a full
step wherever the gradient is at rounding level)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import models as JM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import pgd as JP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import pgd as PP

SIZE = 64


@pytest.fixture(scope="module")
def victim():
    blocks = JM.tiny_test_blocks()
    jnet = JM.build_network(blocks)
    jparams = JM.fold_bn(jnet, JM.init_params(jnet, jax.random.PRNGKey(6)))
    pnet = PM.build_network(blocks)
    return jnet, jparams, pnet, PM.params_from_jax(jparams)


def images(seed, b=2):
    return np.random.default_rng(seed).random((b, SIZE, SIZE, 3)).astype(
        np.float32)


@pytest.mark.parametrize("targeted", [None, 4])
def test_fabrication_loss_matches_jax(targeted):
    rng = np.random.default_rng(0)
    heads = [rng.standard_normal((2, s, s, 3 * 20)).astype(np.float32) * 3
             for s in (2, 4, 8)]
    got = PP.fabrication_loss([torch.from_numpy(h) for h in heads], 15,
                              targeted)
    want = JP.fabrication_loss([jnp.asarray(h) for h in heads], 15, targeted)
    assert float(got) == pytest.approx(float(want), abs=1e-6, rel=0)


@pytest.mark.parametrize("targeted", [None, 2])
def test_image_gradient_matches_jax(victim, targeted):
    jnet, jparams, pnet, pparams = victim
    x = images(1)

    def loss(xx):
        heads = JM.apply(jnet, jparams, xx, jnp.float32)
        return JP.fabrication_loss(heads, 15, targeted)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    model = PM.Darknet(pnet, pparams, torch.float32, device="cpu")
    got = PP.fabrication_grad(model, torch.from_numpy(x), 15,
                              targeted).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5, rel
    assert np.linalg.norm(want) > 0


def test_attack_matches_jax_after_three_steps(victim):
    jnet, jparams, pnet, pparams = victim
    cfg = PP.PGDConfig(steps=3)
    x = images(2)
    want = np.asarray(JP.make_pgd_fabrication(
        jnet, JP.PGDConfig(steps=3))(jparams, jnp.asarray(x)))
    got = PP.make_pgd_fabrication(pnet, cfg)(
        pparams, torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and np.isfinite(got).all()
    assert np.all(np.abs(got - x) <= cfg.eps + 1e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert not np.array_equal(got, x)
    # a pixel's steps either agree with JAX's (the same value) or one of
    # them went the other way (alpha apart per flipped step)
    flipped = np.abs(got - want) > 1e-6
    assert flipped.mean() <= 1e-3, flipped.mean()


def test_attack_moves_the_loss_up(victim):
    """Three steps raise the fabrication objective (the attack's aim)."""
    _, _, pnet, pparams = victim
    x = torch.from_numpy(images(3))
    adv = PP.make_pgd_fabrication(pnet, PP.PGDConfig(steps=3))(pparams, x)
    model = PM.Darknet(pnet, pparams, torch.float32, device="cpu")
    with torch.no_grad():
        before = PP.fabrication_loss(model(x))
        after = PP.fabrication_loss(model(adv))
    assert float(after) > float(before)
