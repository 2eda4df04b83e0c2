"""The port's EOT stack against the JAX package's, at float32 on the CPU:
median pool (values, and gradients that must be exactly equal, ties
included), the affine theta, both warps and their VJPs, and the whole
transform fed with draws rebuilt from a JAX key.

Tolerances: the median pool selects and routes values, so it is exact;
warps interpolate in float32 in different orders (and the grid_sample
route goes through normalized coordinates), atol 1e-5 (of the gradient's
scale, for the VJPs, whose entries sum many taps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import eot as JE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import affine as JA
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import affine_mxu as JAM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import median_pool as JMP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import eot as PE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import affine as PA
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import affine_mxu as PAM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import median_pool as PMP


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


def jax_draws(key, batch, patch_size, cfg):
    """The draws the JAX package's ``transform_patch`` makes from ``key``
    (its key splits repeated), as the port's ``EOTDraws``."""
    k_jit, k_geom, k_angle = jax.random.split(key, 3)
    kc, kb, kn = jax.random.split(k_jit, 3)
    kx, ky = jax.random.split(k_geom)
    u = jax.random.uniform
    vals = dict(
        contrast=u(kc, (batch, 1, 1, 1), minval=cfg.min_contrast,
                   maxval=cfg.max_contrast).reshape(batch),
        brightness=u(kb, (batch, 1, 1, 1), minval=cfg.min_brightness,
                     maxval=cfg.max_brightness).reshape(batch),
        noise=u(kn, (batch, patch_size, patch_size, 3), minval=-1.0,
                maxval=1.0),
        ux=u(kx, (batch,)), uy=u(ky, (batch,)),
        angle=u(k_angle, (batch,), minval=cfg.min_angle,
                maxval=cfg.max_angle))
    return PE.EOTDraws(**{k: torch.from_numpy(np.array(v))
                          for k, v in vals.items()})


def synthetic_labels(rng, batch, max_labels=12, empty_row=None):
    labs = np.full((batch, max_labels, 5), 1e-6, np.float32)
    for i in range(batch):
        k = rng.integers(1, 5)
        labs[i, :k, 0] = rng.integers(0, 15, k)
        labs[i, :k, 1:3] = rng.uniform(0.2, 0.8, (k, 2))
        labs[i, :k, 3:5] = rng.uniform(0.05, 0.3, (k, 2))
    if empty_row is not None:
        labs[empty_row] = 1e-6
        labs[empty_row, 0] = 1.0    # the all-ones sentinel of an empty scene
    return labs


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 13, 9)])
def test_median_pool_values_and_exact_tie_gradients(shape):
    rng = np.random.default_rng(0)
    # multiples of 1/8: windows are full of ties
    x = (rng.integers(0, 8, shape) / 8.0).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: JMP.median_pool_2d_fast(v, 7),
                        jnp.asarray(x))
    want_g = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    got = PMP.median_pool_2d_fast(xt, 7)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)
    # the sort path gives the same values
    np.testing.assert_array_equal(
        PMP.median_pool_2d(torch.from_numpy(x), 7).numpy(),
        np.asarray(JMP.median_pool_2d(jnp.asarray(x), 7)))


def test_median_pool_nhwc_layout():
    rng = np.random.default_rng(1)
    x = (rng.integers(0, 4, (12, 12, 3)) / 4.0).astype(np.float32)
    g = rng.standard_normal((12, 12, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: JMP.median_pool_nhwc_fast(v, 7),
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = PMP.median_pool_nhwc_fast(xt, 7)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


def _geometry(rng, b):
    angle = rng.uniform(-np.pi, np.pi, b).astype(np.float32)
    scale = rng.uniform(0.4, 2.5, b).astype(np.float32)
    tx = rng.uniform(-0.6, 0.6, b).astype(np.float32)
    ty = rng.uniform(-0.6, 0.6, b).astype(np.float32)
    angle[0] = 0.0              # one axis-aligned sample
    angle[1] = np.pi / 2        # one at the conditioning swap
    return angle, scale, tx, ty


def test_theta_matches():
    rng = np.random.default_rng(2)
    args = _geometry(rng, 6)
    want = np.asarray(JA.rotation_scale_translation_theta(
        *[jnp.asarray(a) for a in args]))
    got = PA.rotation_scale_translation_theta(
        *[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("method", ["mxu", "gather"])
def test_warps_and_their_vjps_match(method):
    rng = np.random.default_rng(3)
    b, p, s = 4, 12, 40
    theta = np.asarray(JA.rotation_scale_translation_theta(
        *[jnp.asarray(a) for a in _geometry(rng, b)]))
    img = rng.random((b, p, p, 3)).astype(np.float32)
    g = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    pad = (s - p) // 2
    kw = dict(src_hw=(s, s), offset=(pad, pad))
    if method == "mxu":
        def jfn(v):
            return JAM.affine_warp_mxu(v, jnp.asarray(theta), (s, s), **kw)

        def pfn(v):
            return PAM.affine_warp_mxu(v, torch.from_numpy(theta), (s, s),
                                       **kw)
    else:
        def jfn(v):
            return JA.affine_sample_fast(v, jnp.asarray(theta), (s, s),
                                         window=JE.max_zoom_window(s, p),
                                         **kw)

        def pfn(v):
            return PA.affine_sample(v, torch.from_numpy(theta), (s, s),
                                    with_mask=True, **kw)
    (want, want_m), vjp = jax.vjp(jfn, jnp.asarray(img))
    want_g = np.asarray(vjp((jnp.asarray(g), jnp.zeros_like(want_m)))[0])
    it = torch.from_numpy(img).requires_grad_(True)
    got, got_m = pfn(it)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_m.detach().numpy(), np.asarray(want_m),
                               rtol=0, atol=1e-5)
    assert np.asarray(want_m).max() > 0.99    # the patch lands on the canvas
    # a patch pixel's cotangent sums up to ~25 bilinear taps of g: 1e-5
    # of that sum's scale (the two sides compute the tap weights from
    # coordinates rounded differently)
    scale = max(1.0, float(np.abs(want_g).max()))
    np.testing.assert_allclose(it.grad.numpy(), want_g, rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("method", ["mxu", "gather"])
@pytest.mark.parametrize("photometric,do_rotate",
                         [(True, True), (False, False)])
def test_apply_eot_patch_with_jax_draws(method, photometric, do_rotate):
    rng = np.random.default_rng(4)
    b, p, s = 3, 16, 64
    cfg_kw = dict(img_size=s, warp_method=method, photometric=photometric,
                  do_rotate=do_rotate)
    jcfg, pcfg = JE.EOTConfig(**cfg_kw), PE.EOTConfig(**cfg_kw)
    patch = rng.random((p, p, 3)).astype(np.float32)
    images = rng.random((b, s, s, 3)).astype(np.float32)
    labels = synthetic_labels(rng, b, empty_row=2)
    key = jax.random.PRNGKey(11)
    adv_j, mask_j, cen_j = JE.transform_patch(
        jnp.asarray(patch), jnp.asarray(labels), key, jcfg)
    draws = jax_draws(key, b, p, jcfg)
    adv, mask, cen = PE.transform_patch(
        torch.from_numpy(patch), torch.from_numpy(labels), draws, pcfg)
    np.testing.assert_allclose(cen.numpy(), np.asarray(cen_j), rtol=1e-6)
    np.testing.assert_allclose(mask.numpy(), np.asarray(mask_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j), rtol=0,
                               atol=1e-5)
    patched_j, _ = JE.apply_eot_patch(jnp.asarray(patch),
                                      jnp.asarray(images),
                                      jnp.asarray(labels), key, jcfg)
    patched, _ = PE.apply_eot_patch(
        torch.from_numpy(patch), torch.from_numpy(images),
        torch.from_numpy(labels), draws, pcfg)
    np.testing.assert_allclose(patched.numpy(), np.asarray(patched_j),
                               rtol=0, atol=1e-5)


def test_reference_box_and_center_quirks():
    rng = np.random.default_rng(5)
    labels = synthetic_labels(rng, 4, empty_row=1)
    want = np.asarray(JE.select_reference_box(jnp.asarray(labels)))
    got = PE.select_reference_box(torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got[1] == 0.25)
    draws = PE.draw_eot(torch.Generator().manual_seed(0), 4, 8)
    _, centers, tx, ty = PE.patch_scale_and_center(
        torch.from_numpy(labels), draws, 8, PE.EOTConfig(img_size=64))
    assert float(tx.min()) >= np.float32(0.2)
    assert float(ty.max()) <= np.float32(0.8)
    assert centers.shape == (4, 2)


def test_draw_eot_ranges_and_reproducibility():
    cfg = PE.EOTConfig()
    d1 = PE.draw_eot(torch.Generator().manual_seed(3), 5, 8, cfg)
    d2 = PE.draw_eot(torch.Generator().manual_seed(3), 5, 8, cfg)
    for f in ("contrast", "brightness", "noise", "ux", "uy", "angle"):
        assert torch.equal(getattr(d1, f), getattr(d2, f))
    assert d1.noise.shape == (5, 8, 8, 3)
    assert 0.8 <= float(d1.contrast.min()) <= float(d1.contrast.max()) < 1.2
    assert float(d1.noise.abs().max()) <= 1.0
    assert float(d1.angle.abs().max()) <= np.pi
