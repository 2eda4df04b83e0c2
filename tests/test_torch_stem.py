"""The fused stem (K1): the port's plain version against the JAX package's
XLA stem oracle and its Pallas kernel in interpret mode, at float32.

Tolerance: rtol/atol 2e-5, the JAX package's own for its fused stem
against the same oracle (tests/test_stem_fused.py): both sides
accumulate in float32, in different orders, over five chained convs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import stem_fused as JSF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF


def make_sp(rng):
    """(HWIO numpy weight, bias) pairs for convs 0,1,2,3,5."""
    sp = []
    for cin, cout, k in [(3, 32, 3), (32, 64, 3), (64, 32, 1),
                         (32, 64, 3), (64, 128, 3)]:
        sp.append(((rng.standard_normal((k, k, cin, cout)) * 0.1
                    ).astype(np.float32),
                   (rng.standard_normal(cout) * 0.1).astype(np.float32)))
    return sp


def to_port(sp, dtype=torch.float32):
    """The port's stem params are the JAX package's layout: HWIO."""
    return [(torch.from_numpy(w).to(dtype), torch.from_numpy(b))
            for w, b in sp]


def xla_stem(v, sp):
    def conv(u, w, b, s):
        pad = (w.shape[0] - 1) // 2
        y = lax.conv_general_dilated(
            u, w, (s, s), [(pad, pad), (pad, pad)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=lax.Precision.HIGHEST)
        y = y + b
        return jnp.where(y > 0, y, 0.1 * y)
    sp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in sp]
    y0 = conv(v, *sp[0], 1)
    y1 = conv(y0, *sp[1], 2)
    y2 = conv(y1, *sp[2], 1)
    y3 = conv(y2, *sp[3], 1)
    return conv(y3 + y1, *sp[4], 2)


@pytest.mark.parametrize("h", [32, 64])
def test_fused_stem_plain_matches_xla_oracle(h):
    rng = np.random.default_rng(7)
    sp = make_sp(rng)
    x = rng.random((2, h, h, 3)).astype(np.float32)
    want = np.asarray(xla_stem(jnp.asarray(x), sp))
    xe, xo = SF.split_phases(torch.from_numpy(x))
    y5p = SF.fused_stem_fwd(xe, xo, to_port(sp))
    assert y5p.shape == (2, h // 4, 128, 128)
    got = PC.from_planar_plain(y5p, h // 4, 128).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # the NHWC entry point is the same chain
    np.testing.assert_allclose(
        SF.fused_stem(torch.from_numpy(x), to_port(sp)).numpy(), want,
        rtol=2e-5, atol=2e-5)


def test_fused_stem_plain_matches_pallas_interpret_whole_planar():
    """The whole planar y5, zero border and padding lanes included."""
    rng = np.random.default_rng(7)
    sp = make_sp(rng)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    je, jo = JSF.split_phases(jnp.asarray(x))
    jsp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in sp]
    want = np.asarray(JSF.fused_stem_fwd(je, jo, jsp, interpret=True))
    xe, xo = SF.split_phases(torch.from_numpy(x))
    got = SF.fused_stem_fwd(xe, xo, to_port(sp)).numpy()
    assert got.shape == want.shape == (2, 8, 128, 128)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert not got[..., 0].any() and not got[..., 9:].any()


def test_fused_stem_plain_bf16_rounds_like_the_kernel():
    """In bfloat16 every stored intermediate is a bf16 value: the plain
    version's y5 equals a float32 recomputation that rounds at the same
    points (after each leaky and on the shortcut sum)."""
    rng = np.random.default_rng(3)
    sp = make_sp(rng)
    x = torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    spb = to_port(sp, torch.bfloat16)
    got = SF.fused_stem(xb, spb)
    assert got.dtype == torch.bfloat16

    def conv(u, w, b, s):
        y = torch.nn.functional.conv2d(u, w.permute(3, 2, 0, 1).float(),
                                       None, s, (w.shape[0] - 1) // 2)
        y = y + b.view(1, -1, 1, 1)
        return torch.where(y > 0, y, y * 0.1).bfloat16().float()
    v = xb.float().permute(0, 3, 1, 2)
    y1 = conv(conv(v, *spb[0], 1), *spb[1], 2)
    y3 = conv(conv(y1, *spb[2], 1), *spb[3], 1)
    want = conv((y3 + y1).bfloat16().float(), *spb[4], 2)
    torch.testing.assert_close(got.float(), want.permute(0, 2, 3, 1),
                               rtol=0, atol=0)


def test_fused_stem_refuses_grad():
    rng = np.random.default_rng(1)
    x = torch.rand(1, 32, 32, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        SF.fused_stem(x, to_port(make_sp(rng)))
