"""The port's vanishing-attack transformer (``attack/vanishing.py``)
against the JAX package's, on the CPU: the JAX function's own draws
rebuilt from its key (its key splits repeated) as ``VanishingDraws``,
every option, and the sequential composite.

Tolerance: atol 1e-5 (both warp through the matmul-factored warp in
float32 in different summation orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import eot as JEOT
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import vanishing as JV
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import vanishing as PV


def jax_vanishing_draws(key, n, patch_size, cfg):
    """The draws ``transform_patch_vanishing`` makes from ``key``."""
    k_jit, k_angle, k_ox, k_oy = jax.random.split(key, 4)
    kc, kb, kn = jax.random.split(k_jit, 3)
    j = JEOT.EOTConfig(img_size=cfg.img_size)
    u = jax.random.uniform
    vals = dict(
        contrast=u(kc, (n, 1, 1, 1), minval=j.min_contrast,
                   maxval=j.max_contrast).reshape(n),
        brightness=u(kb, (n, 1, 1, 1), minval=j.min_brightness,
                     maxval=j.max_brightness).reshape(n),
        noise=u(kn, (n, patch_size, patch_size, 3), minval=-1.0, maxval=1.0),
        angle=u(k_angle, (n,), minval=cfg.min_angle, maxval=cfg.max_angle),
        ox=u(k_ox, (n,), minval=-0.2, maxval=0.2),
        oy=u(k_oy, (n,), minval=-0.2, maxval=0.2))
    return PV.VanishingDraws(**{k: torch.from_numpy(np.array(v))
                                for k, v in vals.items()})


def labels_batch():
    labels = np.full((2, 4, 5), 1e-6, np.float32)
    labels[0, 0] = [1, 0.3, 0.3, 0.3, 0.3]
    labels[0, 1] = [2, 0.7, 0.7, 0.25, 0.2]
    labels[0, 2] = [5, 0.5, 0.2, 0.1, 0.4]
    labels[1, 0] = [0, 0.5, 0.5, 0.4, 0.4]
    return labels


@pytest.mark.parametrize("opts", [
    {}, {"test_real": True}, {"rand_loc": True}, {"orient": "left"},
    {"orient": "right", "rand_loc": True}, {"do_rotate": False}])
def test_vanishing_matches_jax(opts):
    p, s = 12, 64
    patch = np.random.default_rng(1).random((p, p, 3)).astype(np.float32)
    labels = labels_batch()
    key = jax.random.PRNGKey(7)
    adv_j = JV.transform_patch_vanishing(
        jnp.asarray(patch), jnp.asarray(labels), key,
        JV.VanishingConfig(img_size=s, **opts))
    cfg = PV.VanishingConfig(img_size=s, **opts)
    draws = jax_vanishing_draws(key, 8, p, cfg)
    adv_p = PV.transform_patch_vanishing(torch.from_numpy(patch),
                                         torch.from_numpy(labels), draws, cfg)
    assert adv_p.shape == (2, 4, s, s, 3)
    np.testing.assert_allclose(adv_p.numpy(), np.asarray(adv_j), atol=1e-5,
                               rtol=0)
    a = adv_p.numpy()
    assert a[0, 0].sum() > 0 and a[0, 1].sum() > 0
    # padding rows give (sub-pixel) empty layers
    assert a[0, 3].sum() < a[0, 0].sum() * 0.01

    imgs = np.random.default_rng(2).random((2, s, s, 3)).astype(np.float32)
    out_j = JV.paste_vanishing(jnp.asarray(imgs), adv_j)
    out_p = PV.paste_vanishing(torch.from_numpy(imgs), adv_p)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=0)
    assert not np.allclose(out_p.numpy()[0], imgs[0])


def test_paste_vanishing_is_sequential():
    """Later label layers overwrite earlier ones where nonzero; exact
    zeros are transparent."""
    imgs = torch.full((1, 4, 4, 3), 0.5)
    adv = torch.zeros(1, 2, 4, 4, 3)
    adv[0, 0, :2] = 0.1
    adv[0, 1, 1:3] = 0.9
    out = PV.paste_vanishing(imgs, adv)[0, :, 0, 0]
    assert out.tolist() == pytest.approx([0.1, 0.9, 0.9, 0.5])


def test_draw_vanishing_ranges():
    cfg = PV.VanishingConfig(img_size=64)
    d = PV.draw_vanishing(torch.Generator().manual_seed(0), 50, 8, cfg)
    assert d.noise.shape == (50, 8, 8, 3)
    assert float(d.contrast.min()) >= 0.8 and float(d.contrast.max()) < 1.2
    assert float(d.ox.abs().max()) <= 0.2 and float(d.oy.abs().max()) <= 0.2
    assert float(d.angle.abs().max()) <= np.pi
    again = PV.draw_vanishing(torch.Generator().manual_seed(0), 50, 8, cfg)
    assert torch.equal(d.angle, again.angle)
