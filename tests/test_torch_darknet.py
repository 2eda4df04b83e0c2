"""The port's detector forward against the JAX package's
``darknet.apply(..., fused_stem=False)`` (the XLA conv walk) on the same
BN-folded weights and inputs, at float32 on the CPU.

Tolerance: 1e-4 relative to the largest head value. Both sides run
float32 convolutions whose sums go in different orders, through up to
75 chained layers; random He-initialised weights grow the heads to ~1e4,
and the worst element differs by ~2e-6 of that."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import models as JM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import darknet as JD
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import weights as JW
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


MINI_CFG = os.path.join(os.path.dirname(__file__), "fixtures", "refparity",
                        "mini_yolov3_dota.cfg")


def _pool_blocks():
    """Every maxpool form: darknet's 2x2/s1 (pad right/bottom), 3x3/s1
    (symmetric pad) and 2x2/s2."""
    def conv(filters, size, stride=1, bn=True, act="leaky"):
        return {"type": "convolutional", "batch_normalize": str(int(bn)),
                "filters": str(filters), "size": str(size),
                "stride": str(stride), "pad": "1", "activation": act}
    return [{"type": "net", "width": "32", "height": "32", "channels": "3"},
            conv(8, 3), {"type": "maxpool", "size": "2", "stride": "1"},
            conv(16, 3, 2), {"type": "maxpool", "size": "3", "stride": "1"},
            {"type": "maxpool", "size": "2", "stride": "2"},
            conv(60, 1, bn=False, act="linear"),
            {"type": "yolo", "mask": "0,1,2", "anchors": JM.DOTA_ANCHORS,
             "classes": "15"}]


def _case(name):
    """(blocks, JAX folded params, image size, expected port stem route)."""
    if name == "mini":
        blocks = JM.parse_darknet_cfg(MINI_CFG)
        net = JM.build_network(blocks)
        params, _ = JW.load_darknet_weights(net, MINI_CFG.replace(
            ".cfg", ".weights"))
        return blocks, JM.fold_bn(net, params), 320, "conv"
    blocks = {"yolov3_full_width": JM.yolov3_blocks(width=64, height=64),
              "tiny": JM.tiny_test_blocks(), "pools": _pool_blocks(),
              "yolov3_width_0.25": JM.yolov3_blocks(
                  width=64, height=64, width_mult=0.25)}[name]
    net = JM.build_network(blocks)
    params = JM.fold_bn(net, JM.init_params(net, jax.random.PRNGKey(1)))
    route = "fused" if name == "yolov3_full_width" else "conv"
    return blocks, params, 32 if name == "pools" else 64, route


@pytest.mark.parametrize("name", ["yolov3_full_width", "tiny", "mini",
                                  "yolov3_width_0.25", "pools"])
def test_apply_matches_jax_conv_walk(name):
    blocks, jparams, size, route = _case(name)
    x = np.random.default_rng(0).random((2, size, size, 3),
                                        dtype=np.float32)
    want = [np.asarray(h) for h in JD.apply(
        JM.build_network(blocks), jparams, jnp.asarray(x), jnp.float32,
        fused_stem=False)]
    pnet = PM.build_network(blocks)
    got = PM.apply(pnet, PM.params_from_jax(jparams), torch.from_numpy(x),
                   torch.float32, fused_stem=True)
    # the fused stem is taken exactly where the geometry allows it
    assert PM.last_routes() == {"stem": route}
    assert len(got) == len(want) == len(pnet.yolo_indices)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale)


def test_module_holds_folded_channels_last_buffers():
    net = PM.build_network(PM.tiny_test_blocks())
    params = PM.init_params(net, 2)  # unfolded BN: the module folds it
    model = PM.Darknet(net, params, torch.bfloat16, device="cpu")
    folded = PM.fold_bn(net, params)
    for spec in PM.conv_specs(net):
        w = getattr(model, f"w{spec.index}")
        assert w.dtype == torch.bfloat16
        assert w.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(w, folded[f"conv_{spec.index}"]["w"].bfloat16())
        assert getattr(model, f"b{spec.index}").dtype == torch.float32
    assert not list(model.parameters())


@pytest.mark.parametrize("width_mult", [1.0, 0.25])
def test_module_prepares_stem_kernel_params_once(width_mult):
    """Where the fused stem applies, the module holds its kernel's
    (contiguous HWIO weight, float32 bias) pairs from build on; the
    0.25-width stem does not fit the kernel and holds none."""
    net = PM.build_network(PM.yolov3_blocks(width=64, height=64,
                                            width_mult=width_mult))
    model = PM.Darknet(net, PM.init_params(net, 3), torch.bfloat16,
                       device="cpu")
    assert model.has_fused_stem == (width_mult == 1.0)
    if not model.has_fused_stem:
        assert not hasattr(model, "sw0")
        return
    folded = model.folded_params()
    for i, (w, b) in zip((0, 1, 2, 3, 5), model.stem_params()):
        assert w.is_contiguous() and w.dtype == torch.bfloat16
        assert torch.equal(w, folded[f"conv_{i}"]["w"].permute(2, 3, 1, 0))
        assert b.dtype == torch.float32


def test_bf16_conv_walk_close_to_jax():
    """bfloat16 compute (conv output, bias add and leaky in bf16, heads
    float32): the two frameworks' CPU bf16 convs round at the same points
    but accumulate differently, so heads agree to a few bf16 ulps of the
    head scale (5%)."""
    blocks = JM.tiny_test_blocks()
    net = JM.build_network(blocks)
    jparams = JM.fold_bn(net, JM.init_params(net, jax.random.PRNGKey(4)))
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    want = JD.apply(net, jparams, jnp.asarray(x), jnp.bfloat16,
                    fused_stem=False)
    got = PM.apply(PM.build_network(blocks), PM.params_from_jax(jparams),
                   torch.from_numpy(x), torch.bfloat16)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=0.05 * float(np.abs(w).max()))


def test_fused_stem_refuses_input_that_requires_grad():
    """The fused route no longer refuses an input that requires grad: it
    takes ``FusedStem`` (K1 with masks, K2; plain versions on the CPU)
    and its input gradient equals the conv walk's (float32, relative L2
    1e-5)."""
    net = PM.build_network(PM.yolov3_blocks(width=64, height=64))
    model = PM.Darknet(net, PM.init_params(net, 0), device="cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    grads = []
    for fused in (True, False):
        xr = x.clone().requires_grad_(True)
        heads = model(xr, fused_stem=fused)
        assert PM.last_routes()["stem"] == ("fused" if fused else "conv")
        sum(h.square().mean() for h in heads).backward()
        grads.append(xr.grad)
    rel = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
    assert rel <= 1e-5, rel
