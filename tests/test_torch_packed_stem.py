"""The space-to-depth packed stem (``experimental/packed_stem.py``) and its
route in ``Darknet`` against the JAX package, at float32 on the CPU.

Tolerances: the packing and the kernel scatters move bits (exact); the
packed stem's output matches the JAX package's packed stem and its plain
two conv layers to 1e-5, as the JAX package's own
``test_packed_stem_exactness``; whole-network heads to atol 1e-3 /
rtol 5e-4, that test's bound for random unnormalised nets (weights damped
by 0.55 as there), whose 70-odd layers amplify reassociation noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import models as JM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.experimental import packed_stem as JPS
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import darknet as JD
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models.darknet import _conv_layer
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.experimental import packed_stem as PS


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


def _folded(blocks, seed=9, damp=0.55):
    """JAX BN-folded params, kernels damped so activations stay O(1)."""
    net = JM.build_network(blocks)
    params = JM.fold_bn(net, JM.init_params(net, jax.random.PRNGKey(seed)))
    return {n: {k: v * damp if k == "w" else v for k, v in p.items()}
            for n, p in params.items()}


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(0).random((2, 6, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        PS._space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(JPS._space_to_depth(jnp.asarray(x))))


@pytest.mark.parametrize("which", ["conv0_00", "conv0_01", "conv0_10",
                                   "conv0_11", "conv1"])
def test_packed_kernel_scatter_matches_jax(which):
    w = np.random.default_rng(1).standard_normal((3, 3, 5, 7)).astype(
        np.float32)
    if which == "conv1":
        got = PS._packed_kernel_conv1(torch.from_numpy(w))
        want = JPS._packed_kernel_conv1(jnp.asarray(w))
    else:
        dy, dx = int(which[-2]), int(which[-1])
        got = PS._packed_kernel_conv0(torch.from_numpy(w), dy, dx)
        want = JPS._packed_kernel_conv0(jnp.asarray(w), dy, dx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["yolov3_stem", "tiny"])
def test_packed_stem_apply_matches_jax(name):
    """YOLOv3's first two convs (3 -> 32 -> 64) and the tiny net's
    (3 -> 8 -> 16)."""
    blocks = (_stem_blocks(64, 32, 64) if name == "yolov3_stem"
              else JM.tiny_test_blocks())
    net = JM.build_network(blocks)
    jp = _folded(blocks)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    l0, l1 = net.layers[0].conv, net.layers[1].conv
    want = np.asarray(JPS.packed_stem_apply(jnp.asarray(x), l0, jp["conv_0"],
                                            l1, jp["conv_1"], jnp.float32))
    plain = np.asarray(_conv_layer(_conv_layer(
        jnp.asarray(x), l0, jp["conv_0"], jnp.float32), l1, jp["conv_1"],
        jnp.float32))
    pp = PM.params_from_jax(jp)
    pnet = PM.build_network(blocks)
    got = PS.packed_stem_apply(torch.from_numpy(x), pnet.layers[0].conv,
                               pp["conv_0"], pnet.layers[1].conv,
                               pp["conv_1"], torch.float32).numpy()
    assert got.shape == want.shape == (2, 32, 32, l1.filters)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)


def _stem_blocks(size, f0, f1, ch=3):
    return ([{"type": "net", "width": str(size), "height": str(size),
              "channels": str(ch)}, _conv(f0, 3), _conv(f1, 3, 2)]
            + _head())


def _conv(filters, size, stride=1):
    return {"type": "convolutional", "batch_normalize": "1",
            "filters": str(filters), "size": str(size),
            "stride": str(stride), "pad": "1", "activation": "leaky"}


def _head(classes=1):
    return [{"type": "convolutional", "batch_normalize": "0",
             "filters": str(3 * (5 + classes)), "size": "1", "stride": "1",
             "pad": "1", "activation": "linear"},
            {"type": "yolo", "mask": "0,1,2", "anchors": JM.DOTA_ANCHORS,
             "classes": str(classes)}]


def _net_blocks(case):
    size, ch, first = 32, 3, [_conv(8, 3), _conv(16, 3, 2)]
    if case == "odd_width":
        size = 31
    elif case == "wide_input":
        ch = 9
    elif case == "first_conv_strided":
        first = [_conv(8, 3, 2), _conv(16, 3, 2)]
    elif case == "second_conv_1x1":
        first = [_conv(8, 3), _conv(16, 1, 2)]
    elif case == "maxpool_second":
        first = [_conv(8, 3), {"type": "maxpool", "size": "2",
                               "stride": "2"}]
    elif case == "layer0_saved":
        first = [_conv(8, 3), _conv(16, 3, 2), {"type": "route",
                                                "layers": "0"}]
    return ([{"type": "net", "width": str(size), "height": str(size),
              "channels": str(ch)}] + first + _head())


APPLICABLE = ["plain", "odd_width", "wide_input", "first_conv_strided",
              "second_conv_1x1", "maxpool_second", "layer0_saved", "yolov3",
              "tiny"]


@pytest.mark.parametrize("case", APPLICABLE)
def test_stem_applicable_matches_jax(case):
    blocks = (JM.yolov3_blocks(width=64, height=64) if case == "yolov3"
              else JM.tiny_test_blocks() if case == "tiny"
              else _net_blocks(case))
    want = JPS.stem_applicable(JM.build_network(blocks))
    assert PS.stem_applicable(PM.build_network(blocks)) == want
    assert want == (case in ("plain", "yolov3", "tiny"))


@pytest.mark.parametrize("name", ["yolov3", "tiny"])
def test_darknet_packed_route_matches_jax(name):
    """Heads and route of ``Darknet(...)(x, packed_stem=True)`` against the
    JAX package's ``apply(packed_stem=True)``; ``apply`` takes it too."""
    blocks = (JM.yolov3_blocks(width=64, height=64) if name == "yolov3"
              else JM.tiny_test_blocks())
    jp = _folded(blocks)
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    want = JM.apply(JM.build_network(blocks), jp, jnp.asarray(x),
                    packed_stem=True)
    assert JD.last_routes()["stem"] == "packed"
    pnet = PM.build_network(blocks)
    model = PM.Darknet(pnet, PM.params_from_jax(jp), device="cpu")
    assert model.has_packed_stem
    got = model(torch.from_numpy(x), packed_stem=True)
    assert PM.last_routes() == {"stem": "packed", "res152": "conv"}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-3, rtol=5e-4)
    again = PM.apply(pnet, PM.params_from_jax(jp), torch.from_numpy(x),
                     packed_stem=True)
    assert PM.last_routes()["stem"] == "packed"
    for a, g in zip(again, got):
        assert torch.equal(a, g)


def test_packed_stem_skipped_for_unfolded_params():
    """BN params as passed (not folded): the JAX predicate falls back to
    the conv walk, and so does the port, though it folds them itself."""
    net = PM.build_network(PM.yolov3_blocks(width=64, height=64))
    model = PM.Darknet(net, PM.init_params(net, 3), device="cpu")
    assert not model.has_packed_stem
    heads = model(torch.zeros(1, 64, 64, 3), packed_stem=True)
    assert PM.last_routes()["stem"] == "conv"
    assert tuple(heads[0].shape) == (1, 2, 2, 60)


def test_packed_stem_comes_after_the_kernel_stems():
    """As the JAX ``apply``: the packed stem is tried only where no kernel
    stem was taken; its gradient flows through plain convs."""
    blocks = JM.yolov3_blocks(width=64, height=64)
    pnet = PM.build_network(blocks)
    model = PM.Darknet(pnet, PM.params_from_jax(_folded(blocks)),
                       device="cpu")
    x = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    model(x, fused_stem=True, packed_stem=True)
    assert PM.last_routes()["stem"] == "fused"
    xr = x.clone().requires_grad_(True)
    heads = model(xr, packed_stem=True)
    assert PM.last_routes()["stem"] == "packed"
    sum(h.square().mean() for h in heads).backward()
    xw = x.clone().requires_grad_(True)
    sum(h.square().mean() for h in model(xw)).backward()
    rel = ((xr.grad - xw.grad).norm() / xw.grad.norm()).item()
    assert rel <= 1e-4, rel
    with torch.no_grad():
        bf = PM.Darknet(pnet, PM.params_from_jax(_folded(blocks)),
                        torch.bfloat16, device="cpu")(x, packed_stem=True)
    assert PM.last_routes()["stem"] == "packed"
    assert all(bool(torch.isfinite(h).all()) for h in bf)
