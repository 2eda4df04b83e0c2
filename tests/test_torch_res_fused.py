"""The 152^2 residual stage off the conv walk against the JAX package, at
float32 on the CPU: the whole-stage kernels' plain versions (K6a with and
without its masks, K6b) and the per-layer planar route (``res152_planar``
on K4's plain version), each against the XLA NHWC oracle of
``tests/test_res_fused.py`` (H = 16, C = 128) and ``jax.grad`` of it, at
that file's tolerances (2e-4 forward, 3e-4 backward). The megakernels'
interpret-mode runs are ``slow`` in the JAX package and are not repeated
here; the kernels themselves are held against these plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.models import res_planar as PRP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import res_fused as RF
from test_res_fused import C, H, _conv, _ref_stage, _stage_params

SLIM_CFG = os.path.join(os.path.dirname(__file__), "fixtures",
                        "refparity_slim", "yolov3_dota_slim.cfg")


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


def _port(sp):
    return RF.res_weights([(torch.from_numpy(np.array(w)),
                            torch.from_numpy(np.array(b))) for w, b in sp])


def _k4_bwd(bwd):
    return [(wt, torch.zeros(wt.shape[-1])) for wt in bwd]


def test_fused_plain_forward_matches_xla():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, H, H, C)), jnp.float32)
    sp = _stage_params(rng)
    want = np.asarray(_ref_stage(x, sp))
    fwd, _ = _port(sp)
    y11p = RF.res152_fused(PC.to_planar(torch.from_numpy(np.array(x))), fwd)
    assert tuple(y11p.shape) == (2, H, C, 128)
    got = PC.from_planar(y11p, H, C).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert not y11p[..., 0].any() and not y11p[..., H + 1:].any()


def test_fused_plain_backward_matches_autodiff():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((1, H, H, C)), jnp.float32)
    sp = _stage_params(rng)
    want = np.asarray(jax.grad(lambda t: jnp.sum(_ref_stage(t, sp) ** 2))(x))
    fwd, bwd = _port(sp)
    xp = PC.to_planar(torch.from_numpy(np.array(x)))
    y11p, *masks = RF.res152_fused(xp, fwd, save=True)
    # the save variant's primal is the forward alone's
    assert torch.equal(y11p, RF.res152_fused(xp, fwd))
    g5p = RF.res152_fused_grad(2.0 * y11p, masks, bwd)
    got = PC.from_planar(g5p, H, C).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    assert not g5p[..., 0].any() and not g5p[..., H + 1:].any()


def test_fused_masks_are_the_stored_signs():
    """The masks are int8 signs of a, post7, c and post10 (the XLA
    oracle's, but for values within float32 summation order of 0), in the
    planar layout with zero border and padding lanes."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((1, H, H, C)), jnp.float32)
    sp = _stage_params(rng)
    (w6, b6), (w7, b7), (w9, b9), (w10, b10) = sp
    a = _conv(x, w6, b6, 1)
    post7 = _conv(a, w7, b7, 3)
    c = _conv(post7 + x, w9, b9, 1)
    post10 = _conv(c, w10, b10, 3)
    fwd, _ = _port(sp)
    _, *masks = RF.res152_fused(PC.to_planar(torch.from_numpy(np.array(x))),
                                fwd, save=True)
    for m, v, ch in zip(masks, (a, post7, c, post10), (64, 128, 64, 128)):
        assert m.dtype == torch.int8 and tuple(m.shape) == (1, H, ch, 128)
        assert not m[..., 0].any() and not m[..., H + 1:].any()
        v = np.asarray(v)
        got = PC.from_planar(m, H, ch).numpy()
        sure = np.abs(v) > 1e-4
        np.testing.assert_array_equal(got[sure], (v[sure] > 0))


def test_planar_route_matches_xla_and_autodiff():
    """``res152_planar`` (K4's plain version, the flipped-kernel backward
    with its gates) against the same oracle, forward and backward."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((1, H, H, C)), jnp.float32)
    sp = _stage_params(rng)
    want_y = np.asarray(_ref_stage(x, sp))
    want_g = np.asarray(jax.grad(lambda t: jnp.sum(_ref_stage(t, sp) ** 2))(
        x))
    fwd, bwd = _port(sp)
    xt = torch.from_numpy(np.array(x)).requires_grad_(True)
    y = PRP.res152_planar(xt, fwd, _k4_bwd(bwd))
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=2e-4,
                               atol=2e-4)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=3e-4,
                               atol=3e-4)
    # and the whole-stage route's autograd Function gives the same
    xf = torch.from_numpy(np.array(x)).requires_grad_(True)
    (PRP.res152_fused_stage(xf, fwd, bwd) ** 2).sum().backward()
    np.testing.assert_allclose(xf.grad.numpy(), want_g, rtol=3e-4,
                               atol=3e-4)


def test_res_weights_layout_and_checks():
    rng = np.random.default_rng(4)
    fwd, bwd = _port(_stage_params(rng))
    assert [tuple(w.shape) for w, _ in fwd] == list(RF.FWD_SHAPES)
    assert [tuple(w.shape) for w in bwd] == list(RF.BWD_SHAPES)
    for (w, b), wt in zip(fwd, bwd):
        assert wt.is_contiguous() and b.dtype == torch.float32
        assert torch.equal(wt, torch.flip(w, (0, 1)).permute(0, 1, 3, 2))
    cpu = torch.device("cpu")
    RF._check_weights("k", bwd, RF.BWD_SHAPES, torch.float32, cpu)
    with pytest.raises(ValueError, match="weight"):
        RF._check_weights("k", [w for w, _ in fwd], RF.BWD_SHAPES,
                          torch.float32, cpu)
    with pytest.raises(ValueError, match="weight"):
        RF._check_weights("k", bwd, RF.BWD_SHAPES, torch.bfloat16, cpu)


@pytest.mark.parametrize("name,res,fused", [
    ("yolov3", True, True), ("yolov3_width_0.25", True, False),
    ("slim", True, False), ("tiny", False, False)])
def test_stage_applicability(name, res, fused):
    if name == "slim":
        net = PM.network_from_cfg(SLIM_CFG)
    elif name == "tiny":
        net = PM.build_network(PM.tiny_test_blocks())
    else:
        net = PM.build_network(PM.yolov3_blocks(
            width=64, height=64, width_mult=0.25 if "0.25" in name else 1.0))
    params = PM.fold_bn(net, PM.init_params(net, 0))
    assert PRP.res152_applicable(net, params) == res
    assert PRP.fused_res_applicable(net, params, (2, 64, 64, 3)) == fused
    # unfolded batch-norm params take no kernel route
    assert not PRP.res152_applicable(net, PM.init_params(net, 0))
    assert not PRP.fused_res_shape_ok((2, 64, 32, 3))
