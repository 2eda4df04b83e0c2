"""The port's eval-time placement (``attack/eot_eval.py``) against the JAX
package's, on the CPU: the reference box, the occupancy map, the warped
mask's half-edge and the whole ``transform_patch_eval`` for the same
``np.random.default_rng`` seed.

Tolerances: the reference box, the occupancy map, the stage-1 mask, its
half-edge and the placement are exact (the port's warp is the JAX
package's bilinear gather op for op); the canvas atol 1e-5."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import eot_eval as JEE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import affine as JA
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.utils import native as JN
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import eot_eval as PEE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.utils import native as PN


def label_sets():
    """Named [L, 7] label sets: ordinary scenes, a single row (the 0.25
    dummy), the all-ones sentinel, a crowded scene that fills the map
    (the early exit), a degenerate (zero-area) set and an all-inf set
    (exp-overflow detections of an untrained victim)."""
    rng = np.random.default_rng(11)

    def scene(n, lo=0.03, hi=0.3):
        rows = np.zeros((n, 7), np.float32)
        rows[:, 0:2] = rng.uniform(0.05, 0.95, (n, 2))
        rows[:, 2:4] = rng.uniform(lo, hi, (n, 2))
        rows[:, 4:6] = rng.uniform(0.01, 1.0, (n, 2))
        rows[:, 6] = rng.integers(0, 15, n)
        return rows

    degenerate = scene(5)
    degenerate[:, 2:4] = 0.0
    all_inf = np.full((40, 7), np.inf, np.float32)
    all_inf[:, 4:6] = 0.9
    mixed = scene(12)
    mixed[::3, 0:4] = np.nan
    return {"two": scene(2), "six": scene(6), "twenty": scene(20),
            "small_boxes": scene(30, 0.005, 0.03), "one": scene(1),
            "sentinel": np.ones((1, 7), np.float32),
            "crowded": scene(60, 0.2, 0.5), "degenerate": degenerate,
            "all_inf": all_inf, "nan_rows": mixed}


LABELS = label_sets()


@pytest.mark.parametrize("name", sorted(LABELS))
def test_reference_box_exact(name):
    np.testing.assert_array_equal(
        PEE.select_reference_box_7col(LABELS[name]),
        JEE.select_reference_box_7col(LABELS[name]))


@pytest.fixture
def numpy_twins(monkeypatch):
    """Both packages' native loaders disabled: their numpy twins run."""
    for mod in (PN, JN):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)


@pytest.mark.parametrize("name", sorted(LABELS))
@pytest.mark.parametrize("semi_edge", [0.0, 5.5, 31.0])
def test_interference_map_exact(name, semi_edge):
    got = PEE.interference_map(LABELS[name], semi_edge, 96)
    np.testing.assert_array_equal(
        got, JEE.interference_map(LABELS[name], semi_edge, 96))
    assert PN.available()


@pytest.mark.parametrize("name", ["two", "twenty", "crowded", "all_inf"])
def test_interference_map_numpy_twin_exact(name, numpy_twins):
    for se in (0.0, 7.0):
        got = PEE.interference_map(LABELS[name], se, 64)
        np.testing.assert_array_equal(
            got, JEE.interference_map(LABELS[name], se, 64))
        assert not PN.available()


def jax_stage1_mask(angle, scale, s, p):
    theta = JA.rotation_scale_translation_theta(
        jnp.asarray([angle]), jnp.asarray([scale], jnp.float32),
        jnp.zeros(1), jnp.zeros(1))
    pad = (s - p) // 2
    _, mask = JA.affine_sample(jnp.zeros((1, p, p, 3)), theta, (s, s),
                               src_hw=(s, s), offset=(pad, pad),
                               with_mask=True)
    return np.asarray(mask[0])


@pytest.mark.parametrize("s,p", [(608, 224), (64, 16)])
def test_stage1_mask_and_semi_edge_exact(s, p):
    """The stage-1 mask bit for bit and its half-edge, over angles in
    [-90, 90] deg and scales from the floor to the canvas. Angles whose
    float32 sine or cosine XLA rounds an ulp away from the correctly
    rounded value are the documented exception for the mask; the
    half-edge is held at every angle."""
    rng = np.random.default_rng(5)
    equal_masks = 0
    n = 24
    for _ in range(n):
        angle = float(rng.uniform(-math.pi / 2, math.pi / 2))
        scale = float(rng.uniform(0.01, s / p))
        _, mask = PEE._sample(torch.zeros(1, p, p, 3),
                              PEE._theta(angle, scale), s,
                              offset=(s - p) // 2, with_mask=True)
        got = mask[0].numpy()
        want = jax_stage1_mask(angle, scale, s, p)
        jtheta = np.asarray(JA.rotation_scale_translation_theta(
            jnp.asarray([angle]), jnp.asarray([scale], jnp.float32),
            jnp.zeros(1), jnp.zeros(1)))
        if np.array_equal(jtheta, PEE._theta(angle, scale)):
            np.testing.assert_array_equal(got, want)
            equal_masks += 1
        assert PEE.mask_semi_edge(got) == JEE.mask_semi_edge(want)
    assert equal_masks >= n - 2


@pytest.mark.parametrize("name", sorted(LABELS))
@pytest.mark.parametrize("s,p,seed", [(608, 224, 0), (96, 24, 3)])
def test_transform_patch_eval_matches_jax(name, s, p, seed):
    """The same patch, labels and generator seed: equal placement, the
    canvas within 1e-5, and both generators left in the same state."""
    patch = np.random.default_rng(seed + 100).random((p, p, 3)).astype(
        np.float32)
    cfg_j = JEE.EvalEOTConfig(img_size=s)
    cfg_p = PEE.EvalEOTConfig(img_size=s)
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    adv_j, (txj, tyj) = JEE.transform_patch_eval(
        jnp.asarray(patch), LABELS[name], rj, cfg_j)
    adv_p, (txp, typ) = PEE.transform_patch_eval(
        torch.from_numpy(patch), LABELS[name], rp, cfg_p)
    assert (txp, typ) == (txj, tyj)
    assert adv_p.shape == (s, s, 3)
    np.testing.assert_allclose(adv_p.numpy(), np.asarray(adv_j), atol=1e-5,
                               rtol=0)
    assert np.isfinite(adv_p.numpy()).all()
    assert rp.integers(0, 1 << 30) == rj.integers(0, 1 << 30)


def test_transform_patch_eval_places_and_pastes():
    """The JAX package's placement scenario: a visible patch inside the
    canvas, composited by ``paste_patch``."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import paste_patch
    patch = torch.from_numpy(np.random.default_rng(0).random(
        (8, 8, 3)).astype(np.float32))
    labels = np.array([[0.5, 0.5, 0.3, 0.3, 0.9, 0.9, 3],
                       [0.15, 0.8, 0.1, 0.12, 0.8, 0.9, 4]], np.float32)
    adv, (tx, ty) = PEE.transform_patch_eval(
        patch, labels, np.random.default_rng(0), PEE.EvalEOTConfig(64))
    assert adv.shape == (64, 64, 3) and float(adv.sum()) > 0
    assert 0 <= tx <= 1 and 0 <= ty <= 1
    out = paste_patch(torch.full((1, 64, 64, 3), 0.5), adv[None])
    assert not torch.allclose(out, torch.full_like(out, 0.5))
