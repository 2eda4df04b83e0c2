"""K4's stride-2 adjoint variant (``planar_conv_t2``) and the bfloat16
K4's fragment-order weights, on the CPU.

- ``planar_conv_t2``'s plain version against the JAX package's
  formulation of the same function, ``planar_conv(expand2_planar(g),
  _flip_t(w), 0, k=3, slope=None[, gate])`` with the Pallas kernel in
  interpret mode, at the slim stem's adjoint widths (conv1^T 16 -> 8,
  conv5^T 32 -> 16) and an odd one (24 -> 12, with a gate): float32
  within 1e-5, bfloat16 within two bf16 ulps of the output scale (the
  two frameworks may round one intermediate apart).
- ``k4_weights``: the fragments ``mma.sync`` reads, with cin zero-padded
  to a multiple of 16 and cout to the kernel's channel block, for widths
  that are multiples of neither; built once per weight tensor.
- The wrapper's geometry rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import stem_planar as JSP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import planar_conv as JP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC


def _t(a):
    return torch.from_numpy(np.array(a))


# (adjoint cin, adjoint cout, gate): the forward conv is cout -> cin
T2_WIDTHS = [(16, 8, False), (32, 16, False), (24, 12, True)]


def _t2_inputs(cin, cout, gate, seed):
    rng = np.random.default_rng(seed)
    hg = 8
    g = rng.standard_normal((1, hg, hg, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cout, cin)) * 0.2).astype(np.float32)
    gt = (rng.standard_normal((1, 2 * hg, 2 * hg, cout)).astype(np.float32)
          if gate else None)
    return hg, g, w, gt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout,gate", T2_WIDTHS)
def test_t2_plain_matches_pallas_expand_formulation(cin, cout, gate, dtype):
    hg, g, w, gt = _t2_inputs(cin, cout, gate, cin + cout)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    gp = JP.to_planar(jnp.asarray(g, jdt))
    wt = JSP._flip_t(jnp.asarray(w, jdt))
    gate_p = None if gt is None else JP.to_planar(jnp.asarray(gt, jdt))
    want = np.asarray(JP.planar_conv(
        JP.expand2_planar(gp, hg), wt, jnp.zeros(cout, jnp.float32),
        k=3, slope=None, gate=gate_p, interpret=True).astype(jnp.float32))
    got = PC.planar_conv_t2(
        _t(gp.astype(jnp.float32)).to(tdt), PC.flip_t(_t(w).to(tdt)),
        torch.zeros(cout), w_img=hg,
        gate=None if gate_p is None else _t(
            gate_p.astype(jnp.float32)).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert tuple(got.shape) == (1, 2 * hg, cout, 128)
    scale = float(np.abs(want).max())
    tol = 1e-5 * max(scale, 1.0) if dtype == "float32" else 2.0 ** -6 * scale
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    assert not got[..., 0].any() and not got[..., 2 * hg + 1:].any()


@pytest.mark.parametrize("cin,cout,gate", T2_WIDTHS)
def test_t2_is_the_stride2_input_cotangent(cin, cout, gate):
    """The variant's function is the input cotangent of the stride-2 conv
    (autograd of ``F.conv2d``), gated like the stem's conv1^T."""
    hg, g, w, gt = _t2_inputs(cin, cout, gate, 7 * cin + cout)
    x = torch.zeros(1, cout, 2 * hg, 2 * hg, requires_grad=True)
    y = torch.nn.functional.conv2d(x, _t(w).permute(3, 2, 0, 1), None, 2, 1)
    want = torch.autograd.grad(y, x, _t(g).permute(0, 3, 1, 2))[0]
    if gt is not None:
        want = want * torch.where(_t(gt).permute(0, 3, 1, 2) > 0, 1.0, 0.1)
    got = PC.planar_conv_t2(
        PC.to_planar(_t(g)), PC.flip_t(_t(w)), torch.zeros(cout), w_img=hg,
        gate=None if gt is None else PC.to_planar(_t(gt)))
    got = PC.from_planar(got, 2 * hg, cout).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_t2_wrapper_geometry_rules():
    g = torch.zeros(1, 8, 16, 128)
    w = torch.zeros(3, 3, 16, 12)
    assert tuple(PC.planar_conv_t2(g, w, torch.zeros(12), w_img=8).shape) \
        == (1, 16, 12, 128)
    # a w_img that does not match the planar width
    with pytest.raises(ValueError, match="planar geometry"):
        PC.planar_conv_t2(g, w, torch.zeros(12), w_img=130)
    with pytest.raises(ValueError, match="weight"):
        PC.planar_conv_t2(g, torch.zeros(3, 3, 17, 12), torch.zeros(12),
                          w_img=8)


def _unfragment(f):
    """Invert ``mma_weights``: [taps, K/16, N/8, 32, 4] -> [taps, K, N]."""
    taps, ks, nb = f.shape[:3]
    b = torch.zeros(taps, 16 * ks, 8 * nb, dtype=f.dtype)
    lane = torch.arange(32)
    gi, ti = lane // 4, lane % 4
    for e, dk in enumerate((0, 1, 8, 9)):
        for s in range(ks):
            for j in range(nb):
                b[:, 16 * s + 2 * ti + dk, 8 * j + gi] = f[:, s, j, :, e]
    return b


@pytest.mark.parametrize("k,cin,cout,kdepth,cout_pad", [
    (3, 3, 8, 16, 8), (3, 20, 12, 32, 16), (1, 40, 24, 48, 32),
    (3, 8, 16, 16, 16), (3, 64, 128, 64, 128), (1, 33, 65, 48, 128)])
def test_k4_weights_pad_cin_and_cout_in_the_right_lanes(k, cin, cout, kdepth,
                                                       cout_pad):
    """cin is zero-padded to a multiple of 16 (the 16-deep steps) and cout
    to a multiple of the kernel's channel block (8, 16, 32 or 64 by
    cout), in bfloat16; the real weights sit where ``mma_weights`` of the
    padded HWIO kernel puts them and every padded lane is zero."""
    g = torch.Generator().manual_seed(cin * cout + k)
    w = torch.randn(k, k, cin, cout, generator=g)
    f = PC.k4_weights(w)
    assert f.dtype == torch.bfloat16 and f.is_contiguous()
    assert tuple(f.shape) == (k * k, kdepth // 16, cout_pad // 8, 32, 4)
    assert cout_pad % (8 * PC._k4_nw(cout)) == 0
    b = _unfragment(f)
    assert torch.equal(b[:, :cin, :cout],
                       w.reshape(k * k, cin, cout).bfloat16())
    assert not b[:, cin:].any() and not b[:, :, cout:].any()


def test_k4_weights_built_once_per_weight_tensor():
    """The fragment-order copy is built once per weight tensor and per
    build function (K4's and K1/K2's layouts of one tensor do not
    overwrite each other), and again after the tensor changes in place."""
    w = torch.randn(3, 3, 32, 64, generator=torch.Generator().manual_seed(1))
    f = PC._mma_cached(w, PC.k4_weights)
    assert PC._mma_cached(w, PC.k4_weights) is f
    m = PC._mma_cached(w)
    assert m is not f and PC._mma_cached(w, PC.k4_weights) is f
    assert PC._mma_cached(w) is m
    w.mul_(2)
    f2 = PC._mma_cached(w, PC.k4_weights)
    assert f2 is not f
    assert torch.equal(f2, PC.k4_weights(w))
