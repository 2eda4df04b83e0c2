"""K4's stride-2 adjoint variant (``planar_conv_t2``) and the bfloat16
K4's packed weights, on the CPU.

- ``planar_conv_t2``'s plain version against the JAX package's
  formulation of the same function, ``planar_conv(expand2_planar(g),
  _flip_t(w), 0, k=3, slope=None[, gate])`` with the Pallas kernel in
  interpret mode, at the slim stem's adjoint widths (conv1^T 16 -> 8,
  conv5^T 32 -> 16) and an odd one (24 -> 12, with a gate): float32
  within 1e-5, bfloat16 within two bf16 ulps of the output scale (the
  two frameworks may round one intermediate apart).
- ``k4_weights``: the chunks the ``wgmma`` kernel streams, with cin
  zero-padded to whole channel chunks and cout to the block's channel
  width, for widths that are multiples of neither; built once per weight
  tensor.
- The wrapper's geometry rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import stem_planar as JSP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import planar_conv as JP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from test_torch_k4_wgmma_layout import k4_unpack


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


@pytest.mark.parametrize("k,cin,cout,kdepth,cout_pad", [
    (3, 3, 8, 16, 8), (3, 20, 12, 32, 16), (1, 40, 24, 48, 32),
    (3, 8, 16, 16, 16), (3, 64, 128, 64, 128), (1, 33, 65, 48, 128)])
def test_k4_weights_pad_cin_and_cout_in_the_right_lanes(k, cin, cout, kdepth,
                                                       cout_pad):
    """cin is zero-padded to whole channel chunks (16 ``ns`` channels of
    ``k4_plan``) and cout to whole channel blocks (8, 16, 32 or 64
    channels by cout), in bfloat16; the real weights sit where the documented
    formula (``tests/test_torch_k4_wgmma_layout.py: k4_unpack``) puts
    them and every padded byte is zero."""
    g = torch.Generator().manual_seed(cin * cout + k)
    w = torch.randn(k, k, cin, cout, generator=g)
    ns, n, n_cb, kd = PC.k4_plan(k, 1, cin, cout)
    assert (kd, n_cb * n) == (kdepth, cout_pad)
    f = PC.k4_weights(w, ns, n)
    assert f.dtype == torch.bfloat16 and f.is_contiguous()
    nck = -(-kdepth // (16 * ns))
    assert tuple(f.shape) == (n_cb * nck * -(-(k * k * ns) // 4), n, 64)
    got, rest = k4_unpack(f, k, cin, cout, ns, n)
    want = w.reshape(k * k, cin, cout).bfloat16()
    assert np.array_equal(got, want.view(torch.int16).numpy().astype(
        np.uint16))
    assert not rest.any()


def test_k4_weights_built_once_per_weight_tensor():
    """The packed copy is built once per weight tensor and per build
    function (K4's and the fragment-order layouts of one tensor do not
    overwrite each other), and again after the tensor changes in place."""
    w = torch.randn(3, 3, 32, 64, generator=torch.Generator().manual_seed(1))
    ns, n, _, _ = PC.k4_plan(3, 1, 32, 64)
    build = PC._k4_builder(ns, n)
    f = PC._mma_cached(w, build)
    assert PC._mma_cached(w, PC._k4_builder(ns, n)) is f
    m = PC._mma_cached(w)
    assert m is not f and PC._mma_cached(w, build) is f
    assert PC._mma_cached(w) is m
    w.mul_(2)
    f2 = PC._mma_cached(w, build)
    assert f2 is not f
    assert torch.equal(f2, PC.k4_weights(w, ns, n))
