"""The generic planar conv (K4) and the per-layer planar stem against the
JAX package, at float32 on the CPU.

- ``planar_conv_plain`` against the Pallas ``planar_conv`` in interpret
  mode for every geometry of ``tests/test_planar_conv.py`` and its gate
  cases, at rtol and atol 1e-4 (that file's own tolerance against the
  XLA reference; batch 1, as interpret mode is slow); ``expand2_planar``
  exactly.
- ``planar_stem`` forward and backward on the narrow stem of
  ``tests/test_planar_conv.py`` at 64^2, against its XLA ``_ref_stem``
  and ``jax.grad`` of it, at rtol 1e-5 and 1e-4 (that file's tolerances;
  its interpret-mode runs are ``slow`` there, so the JAX side here is the
  XLA oracle).
- The wrapper's geometry and weight-layout rules, and the bf16 rounding
  points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import planar_conv as JP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.models import stem_planar as PSP
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from test_planar_conv import _ref_stem, _tiny_stem_params


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


# tests/test_planar_conv.py:17-28
GEOMETRIES = [
    ("conv0-like", 32, 3, 8, 3, 1, 8, False),
    ("conv1-like s2", 32, 8, 16, 3, 2, None, False),
    ("k1", 32, 16, 8, 1, 1, None, False),
    ("k1+res", 32, 16, 8, 1, 1, None, True),
    ("conv3-like", 32, 16, 16, 3, 1, None, False),
    ("k3+res", 32, 16, 16, 3, 1, None, True),
    ("Kchunk s2", 32, 48, 32, 3, 2, None, False),
    ("odd-rout s2", 24, 8, 8, 3, 2, None, False),
]


@pytest.mark.parametrize("name,h,cin,cout,k,s,cstore,res", GEOMETRIES)
def test_planar_conv_plain_matches_pallas_interpret(name, h, cin, cout, k,
                                                   s, cstore, res):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((1, h, h, cin)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((k, k, cin, cout)) * 0.2,
                    jnp.float32)
    b = jnp.asarray(rng.standard_normal(cout) * 0.1, jnp.float32)
    xp = JP.to_planar(x, c_pad=cstore)
    r = None
    if res:
        r = JP.to_planar(jnp.asarray(
            rng.standard_normal((1, h // s, h // s, cout)), jnp.float32))
    want = np.asarray(JP.planar_conv(xp, w, b, r, k=k, stride=s,
                                     interpret=True))
    got = PC.planar_conv(_t(xp), _t(w), _t(b),
                         None if r is None else _t(r), k=k, stride=s)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert not got[..., 0].any() and not got[..., h // s + 1:].any()


# tests/test_planar_conv.py:59-76
@pytest.mark.parametrize("k,res", [(3, False), (1, False), (1, True)])
def test_planar_conv_plain_gate_matches_pallas_interpret(k, res):
    rng = np.random.default_rng(1)
    h, cin, cout = 32, 16, 8
    x = jnp.asarray(rng.standard_normal((1, h, h, cin)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((k, k, cin, cout)) * 0.2,
                    jnp.float32)
    b = jnp.asarray(rng.standard_normal(cout) * 0.1, jnp.float32)
    xp = JP.to_planar(x)
    gate = JP.to_planar(jnp.asarray(
        rng.standard_normal((1, h, h, cout)), jnp.float32))
    r = None
    if res:
        r = JP.to_planar(jnp.asarray(
            rng.standard_normal((1, h, h, cout)), jnp.float32))
    want = np.asarray(JP.planar_conv(xp, w, b, r, k=k, slope=None,
                                     gate=gate, interpret=True))
    got = PC.planar_conv(_t(xp), _t(w), _t(b),
                         None if r is None else _t(r), k=k, slope=None,
                         gate=_t(gate))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_expand2_planar_exact():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 8, 8, 16)), jnp.float32)
    xp = JP.to_planar(x)
    want = np.asarray(JP.expand2_planar(xp, 8))
    got = PC.expand2_planar(_t(xp), 8)
    assert tuple(got.shape) == want.shape == (2, 16, 16, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cin,cout", [(8, 16), (48, 32)])
def test_s2_adjoint_via_expand(cin, cout):
    """expand2_planar + the stride-1 flipped-kernel conv is the input
    cotangent of the stride-2 conv (autograd of ``F.conv2d``)."""
    rng = np.random.default_rng(3)
    h = 16
    x = torch.from_numpy(rng.standard_normal((2, cin, h, h)).astype(
        np.float32)).requires_grad_(True)
    w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * 0.2)
                         .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, h // 2, h // 2, cout))
                         .astype(np.float32))
    y = torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1), None, 2, 1)
    want = torch.autograd.grad(y, x, g.permute(0, 3, 1, 2))[0]
    gp = PC.planar_conv(PC.expand2_planar(PC.to_planar(g), h // 2),
                        PC.flip_t(w), torch.zeros(cin), k=3, slope=None)
    got = PC.from_planar(gp, h, cin).permute(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def _narrow_stem():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 64, 64, 3)) * 0.5).astype(np.float32)
    sp = _tiny_stem_params(rng)
    return x, sp


def test_planar_stem_forward_matches_xla_reference():
    x, sp = _narrow_stem()
    want = np.asarray(_ref_stem(jnp.asarray(x), sp))
    fwd, _ = PSP.planar_stem_params([(_t(w), _t(b)) for w, b in sp])
    got = PSP.planar_stem(torch.from_numpy(x), fwd)
    assert tuple(got.shape) == want.shape == (2, 16, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_planar_stem_backward_matches_autodiff():
    """The hand backward (flipped kernels, expand2_planar for both
    stride-2 adjoints, the y2/y1/y0 masks as gates) equals jax.grad of
    the NHWC reference chain."""
    x, sp = _narrow_stem()
    want = np.asarray(jax.grad(lambda v: jnp.sum(_ref_stem(v, sp) ** 2))(
        jnp.asarray(x)))
    fwd, bwd = PSP.planar_stem_params([(_t(w), _t(b)) for w, b in sp])
    xr = torch.from_numpy(x).requires_grad_(True)
    out = PSP.planar_stem(xr, fwd, bwd)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(xr.grad.numpy(), want, rtol=1e-4, atol=1e-5)


def test_planar_stem_params_layout():
    """conv0's input channels are padded 3 -> 8 (the planar input's), the
    backward kernels are flipped and channel-swapped, conv0's with 8
    output channels (the JAX package's ``_pad_cout``)."""
    _, sp = _narrow_stem()
    fwd, bwd = PSP.planar_stem_params([(_t(w), _t(b)) for w, b in sp])
    assert tuple(fwd[0][0].shape) == (3, 3, 8, 8)
    assert not fwd[0][0][:, :, 3:].any()
    for (w, _), (wt, z) in zip(fwd, bwd):
        assert wt.is_contiguous() and not z.any()
        assert tuple(z.shape) == (wt.shape[-1],)
        assert torch.equal(wt, torch.flip(w, (0, 1)).permute(0, 1, 3, 2))
    assert tuple(bwd[0][0].shape) == (3, 3, 8, 8)


def test_wrapper_geometry_rules():
    x = torch.zeros(1, 16, 8, 128)
    w = torch.zeros(3, 3, 8, 12)
    # cout 12 is padded to a kernel multiple of 8 but comes out as 12
    assert tuple(PC.pad_cout(w).shape) == (3, 3, 8, 16)
    assert tuple(PC.planar_conv(x, w, torch.zeros(12), k=3).shape) == \
        (1, 16, 12, 128)
    with pytest.raises(ValueError, match="stride"):
        PC.planar_conv(x, w, torch.zeros(12), k=1, stride=2)
    with pytest.raises(ValueError, match="weight"):
        PC.planar_conv(x, torch.zeros(3, 3, 9, 12), torch.zeros(12), k=3)
    with pytest.raises(ValueError, match="planar geometry"):
        PC.planar_conv(torch.zeros(1, 15, 8, 128), w, torch.zeros(12), k=3,
                       stride=2)


def test_plain_bf16_rounds_at_the_kernel_points():
    """bfloat16: one rounding at the store (stride 1), and for stride 2
    the kernel's rounding before res/gate, both within one bf16 ulp of a
    float32 run on the same bf16 values."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16, 8)).astype(
        np.float32)).bfloat16()
    xp = PC.to_planar(x)
    w = torch.from_numpy((rng.standard_normal((3, 3, 8, 16)) * 0.3).astype(
        np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    for s in (1, 2):
        got = PC.planar_conv(xp, w, b, k=3, stride=s)
        ref = PC.planar_conv(xp.float(), w.float(), b, k=3, stride=s)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, ref.bfloat16())
