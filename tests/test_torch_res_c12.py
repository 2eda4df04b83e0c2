"""The conv12-widened stage (layers 6-12: K6a, conv12, and K6c, which
computes conv12's stride-2 input cotangent inside the stage's backward)
against the JAX package, at float32 on the CPU.

- ``res152_fused_grad12``'s plain version, and the ``Res152C12`` unit
  around it, against ``jax.vjp`` of the XLA stage + conv12 + leaky chain
  of ``tests/test_res_fused.py`` (H = 16, C = 128) at that file's
  tolerances (2e-4 forward, 3e-4 backward);
- ``c12_applicable`` gives the JAX package's answer on YOLOv3, the slim
  and tiny victims, a narrow YOLOv3, unfolded batch-norm params and image
  sizes whose JAX stripe height does not halve into a multi-row conv12
  stripe."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import models as JM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import res_planar as JRP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import weights as JW
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.models import res_planar as PRP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import res_fused as RF
from test_res_fused import C, H, _leaky, _ref_stage, _stage_params

SLIM_CFG = os.path.join(os.path.dirname(__file__), "fixtures",
                        "refparity_slim", "yolov3_dota_slim.cfg")


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def c12_case():
    """The stage + conv12 + leaky oracle at H = 16: (x, stage params,
    w12 HWIO, b12, g12, y12 and x's cotangent by jax.vjp)."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, H, H, C)), jnp.float32)
    sp = _stage_params(rng)
    w12 = jnp.asarray(rng.standard_normal((3, 3, C, 2 * C)) * 0.05,
                      jnp.float32)
    b12 = jnp.asarray(rng.standard_normal(2 * C) * 0.1, jnp.float32)

    def ref(t):
        z = lax.conv_general_dilated(
            _ref_stage(t, sp), w12, (2, 2), [(1, 1)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=lax.Precision.HIGHEST) + b12
        return _leaky(z)

    y12, vjp = jax.vjp(ref, x)
    g12 = jnp.asarray(rng.standard_normal(y12.shape), jnp.float32)
    return dict(x=x, sp=sp, w12=w12, b12=b12, g12=g12,
                y12=np.asarray(y12), gx=np.asarray(vjp(g12)[0]))


def _port(case):
    fwd, bwd = RF.res_weights([(_t(w), _t(b)) for w, b in case["sp"]])
    w12 = _t(case["w12"])
    # the model's conv12: OIHW channels_last, bias in the compute dtype
    w12_oihw = w12.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return fwd, bwd, w12_oihw, _t(case["b12"]), RF.res12_weights(w12)


def test_grad12_plain_matches_jax_vjp(c12_case):
    fwd, bwd, w12, b12, w12t = _port(c12_case)
    xp = PC.to_planar(_t(c12_case["x"]))
    y11p, *masks = RF.res152_fused(xp, fwd, save=True)
    y12, m12 = PRP._conv12(PC.from_planar(y11p, H, C), w12, b12)
    np.testing.assert_allclose(y12.numpy(), c12_case["y12"], rtol=2e-4,
                               atol=2e-4)
    g12 = _t(c12_case["g12"])
    gp12p = PC.to_planar(g12 * torch.where(m12 > 0, 1.0, 0.1))
    assert tuple(gp12p.shape) == (2, H // 2, 2 * C, 128)
    n = RF.res152_fused_grad12.launches
    g5p = RF.res152_fused_grad12(gp12p, masks, bwd, w12t)
    assert RF.res152_fused_grad12.launches == n   # plain on the CPU
    assert tuple(g5p.shape) == (2, H, C, 128)
    assert not g5p[..., 0].any() and not g5p[..., H + 1:].any()
    np.testing.assert_allclose(PC.from_planar(g5p, H, C).numpy(),
                               c12_case["gx"], rtol=3e-4, atol=3e-4)


def test_c12_unit_matches_jax_vjp(c12_case):
    """``res152_c12_fused``: planar y5 in, NHWC y12 out; its backward
    (gp12 -> K3a -> K6c) returns a planar g5, which flows back through
    the planar layout to x."""
    fwd, bwd, w12, b12, w12t = _port(c12_case)
    xt = _t(c12_case["x"]).requires_grad_(True)
    y12 = PRP.res152_c12_fused(PC.to_planar(xt), fwd, bwd, w12, b12, w12t)
    np.testing.assert_allclose(y12.detach().numpy(), c12_case["y12"],
                               rtol=2e-4, atol=2e-4)
    y12.backward(_t(c12_case["g12"]))
    np.testing.assert_allclose(xt.grad.numpy(), c12_case["gx"], rtol=3e-4,
                               atol=3e-4)
    with torch.no_grad():
        y = PRP.res152_c12_fused(PC.to_planar(xt), fwd, None, w12, b12)
    assert torch.equal(y, y12.detach())
    with pytest.raises(ValueError, match="backward weights"):
        PRP.res152_c12_fused(PC.to_planar(xt), fwd, bwd, w12, b12)


def _nets(name):
    if name == "slim":
        blocks = JM.parse_darknet_cfg(SLIM_CFG)
        net = JM.build_network(blocks)
        params, _ = JW.load_darknet_weights(net, SLIM_CFG.replace(
            ".cfg", ".weights"))
    else:
        blocks = (JM.tiny_test_blocks() if name == "tiny" else
                  JM.yolov3_blocks(width=64, height=64, width_mult=0.25
                                   if "0.25" in name else 1.0))
        net = JM.build_network(blocks)
        params = JM.init_params(net, jax.random.PRNGKey(0))
    folded = JM.fold_bn(net, params)
    if name.endswith("unfolded"):
        folded = params
    return blocks, net, folded


@pytest.mark.parametrize("name,size,want", [
    ("yolov3", 64, True), ("yolov3", 96, True), ("yolov3", 40, False),
    ("yolov3", 72, False), ("yolov3_width_0.25", 64, False),
    ("yolov3_unfolded", 64, False), ("slim", 64, False), ("tiny", 64, False)])
def test_c12_applicable_matches_jax(name, size, want):
    """The port takes the c12 route exactly where the JAX package does:
    at 40^2 and 72^2 the stage height (10, 18) gives the JAX package a
    stripe of 2 rows, which does not halve into a multi-row conv12 stripe.
    The network half also decides whether the model prepares K6c's
    weight."""
    blocks, jnet, jparams = _nets(name)
    shape = (2, size, size, 3)
    assert JRP.c12_applicable(jnet, jparams, shape) == want
    pnet = PM.build_network(blocks)
    pparams = PM.params_from_jax(jparams)
    assert PRP.c12_applicable(pnet, pparams, shape) == want
    if name in ("yolov3", "slim", "tiny"):
        model = PM.Darknet(pnet, pparams, device="cpu")
        assert model.has_c12 == (name == "yolov3")
        assert hasattr(model, "w12t") == model.has_c12


def test_res12_weights_layout_and_checks():
    g = torch.Generator().manual_seed(2)
    w12 = torch.randn(3, 3, C, 2 * C, generator=g)
    w12t = RF.res12_weights(w12)
    assert tuple(w12t.shape) == RF.W12T_SHAPE and w12t.is_contiguous()
    assert torch.equal(w12t, w12.permute(0, 1, 3, 2))
    cpu = torch.device("cpu")
    RF._check_weights("k", [w12t], [RF.W12T_SHAPE], torch.float32, cpu)
    with pytest.raises(ValueError, match="weight"):
        RF._check_weights("k", [w12], [RF.W12T_SHAPE], torch.float32, cpu)
