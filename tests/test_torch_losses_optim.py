"""The port's creation losses, amsgrad update and plateau schedule
against the JAX package's, at float32 on the CPU.

Tolerances: the losses are the same float32 formulas reduced in other
orders (rtol 1e-6, and 1e-5 where a mean runs over a whole patch); the
amsgrad update (``torch.optim.Adam(amsgrad=True)``) agrees with the same
formula in float64 to float32 rounding over 5 steps, and with the JAX
transform to within that transform's float32 bias correction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import losses as JL
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.data.assets import load_printable_colors
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.train import config as JC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.train import trainer as JT
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.train.optim import scale_by_torch_amsgrad
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import losses as PL
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.train import config as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.train import optim as PO
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.train import trainer as PT


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


def _grad_pair(jfn, pfn, x):
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    pv = pfn(xt)
    pv.backward()
    return float(jv), np.asarray(jg), float(pv), xt.grad.numpy()


@pytest.mark.parametrize("name", ["nps", "tv", "colorfulness"])
def test_patch_losses_and_gradients(name):
    rng = np.random.default_rng(0)
    patch = rng.random((24, 24, 3)).astype(np.float32)
    colors = load_printable_colors()
    jfn, pfn = {
        "nps": (lambda p: JL.nps_loss(p, jnp.asarray(colors)),
                lambda p: PL.nps_loss(p, torch.from_numpy(colors))),
        "tv": (JL.total_variation, PL.total_variation),
        "colorfulness": (JL.colorfulness, PL.colorfulness),
    }[name]
    jv, jg, pv, pg = _grad_pair(jfn, pfn, patch)
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    np.testing.assert_allclose(pg, jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())


def _heads(rng, b, sizes=(2, 4, 8), c=15):
    return [rng.standard_normal((b, s, s, 3 * (5 + c))).astype(np.float32)
            for s in sizes]


@pytest.mark.parametrize("swap_xy", [True, False])
def test_cell_scores_and_creation_losses(swap_xy):
    rng = np.random.default_rng(1)
    b, img = 4, 64
    heads = _heads(rng, b)
    centers = rng.uniform(0, img, (b, 2)).astype(np.float32)
    weights = np.array([1, 1, 1, 0], np.float32)
    jo, jc = JL.extract_cell_scores([jnp.asarray(h) for h in heads],
                                    jnp.asarray(centers), img,
                                    swap_xy=swap_xy)
    po, pc = PL.extract_cell_scores([torch.from_numpy(h) for h in heads],
                                    torch.from_numpy(centers), img,
                                    swap_xy=swap_xy)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6)
    for w in (None, weights):
        jw = None if w is None else jnp.asarray(w)
        pw = None if w is None else torch.from_numpy(w)
        np.testing.assert_allclose(
            float(PL.creation_obj_loss(po, pw)),
            float(JL.creation_obj_loss(jo, jw)), rtol=1e-6)
        np.testing.assert_allclose(
            float(PL.creation_cls_ce_loss(pc, 14, pw)),
            float(JL.creation_cls_ce_loss(jc, 14, jw)), rtol=1e-6)
    np.testing.assert_allclose(float(PL.creation_cls_margin_loss(pc, 14)),
                               float(JL.creation_cls_margin_loss(jc, 14)),
                               rtol=1e-6)


@pytest.mark.parametrize("sigmoid_mode", [True, False])
def test_whole_image_max_extractors(sigmoid_mode):
    rng = np.random.default_rng(2)
    heads = _heads(rng, 3)
    jh = [jnp.asarray(h) for h in heads]
    ph = [torch.from_numpy(h) for h in heads]
    for a, b in zip(PL.max_prob_extract(ph, 14, sigmoid_mode=sigmoid_mode),
                    JL.max_prob_extract(jh, 14, sigmoid_mode=sigmoid_mode)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    for name in ("obj", "cls", "obj*cls", "0.2*obj+0.8*cls"):
        got = PL.max_combined_prob(ph, 14, PC.combine_loss_target(name),
                                   sigmoid_mode=sigmoid_mode)
        want = JL.max_combined_prob(jh, 14, JC.combine_loss_target(name),
                                    sigmoid_mode=sigmoid_mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_config_is_the_same_registry():
    assert PC.LOSS_RECIPES == JC.LOSS_RECIPES
    assert sorted(PC.EXPERIMENTS) == sorted(JC.EXPERIMENTS)
    for name in JC.EXPERIMENTS:
        jd = JC.get_experiment(name).__dict__
        pd = PC.get_experiment(name).__dict__
        assert jd == pd, name
    exp = PC.get_experiment("paper_obj")
    assert (exp.batch_size, exp.patch_size, exp.loss_target) == (24, 224,
                                                                 "obj")


def test_amsgrad_matches_jax_transform_over_5_steps():
    rng = np.random.default_rng(3)
    p0 = rng.random((8, 8, 3)).astype(np.float32)
    grads = [rng.standard_normal((8, 8, 3)).astype(np.float32) * s
             for s in (1.0, 0.1, 3.0, 0.01, 1.0)]
    lrs = [0.03, 0.03, 0.01, 0.03, 0.003]
    tx = scale_by_torch_amsgrad()
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    patch = torch.from_numpy(p0.copy()).requires_grad_(True)
    opt = PO.make_optimizer(patch, 0.03)
    # the same update in float64: torch's formula, bias corrections exact
    b1, b2, eps = 0.9, 0.999, 1e-8
    p64, m, v, vmax = p0.astype(np.float64), 0.0, 0.0, 0.0
    moved = 0.0
    for t, (g, lr) in enumerate(zip(grads, lrs), start=1):
        upd, state = tx.update(jnp.asarray(g), state)
        jp = jnp.clip(jp - lr * upd, 0.0, 1.0)
        patch.grad = torch.from_numpy(g)
        PO.amsgrad_step(opt, patch, lr)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.astype(np.float64) ** 2
        vmax = np.maximum(vmax, v)
        p64 = np.clip(p64 - lr * (m / (1 - b1 ** t)) / (
            np.sqrt(vmax) / np.sqrt(1 - b2 ** t) + eps), 0.0, 1.0)
        got = patch.detach().numpy()
        # float32 state and arithmetic against the float64 formula
        np.testing.assert_allclose(got, p64, rtol=0, atol=4e-7)
        # the JAX transform takes 1 - b2^t in float32, which is off by up
        # to 1.3e-5 relative (1 - 0.999 cancels), so its step differs
        # from torch's by up to 7e-6 of the step's size, lr per element
        moved += lr
        np.testing.assert_allclose(got, np.asarray(jp), rtol=0,
                                   atol=7e-6 * moved + 4e-7)
    assert float(patch.min()) >= 0.0 and float(patch.max()) <= 1.0


def test_plateau_schedule_matches():
    j = JT.ReduceLROnPlateau(0.03, patience=3)
    p = PT.ReduceLROnPlateau(0.03, patience=3)
    metrics = [5, 4, 4, 4, 4, 4, 3.99999, 4, 4, 4, 4, 2, 2, 2, 2, 2]
    for m in metrics:
        assert p.step(m) == j.step(m)
    assert p.lr < 0.03
    assert p.state_dict() == j.state_dict()
    q = PT.ReduceLROnPlateau(1.0)
    q.load_state_dict(p.state_dict())
    assert q.state_dict() == p.state_dict()
