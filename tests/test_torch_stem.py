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


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


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
    """An input that requires grad is refused without the backward
    kernel's weights; with them, ``FusedStem``'s input gradient (plain K1
    with masks, plain K2) equals the conv walk's autograd gradient."""
    rng = np.random.default_rng(1)
    sp = to_port(make_sp(rng))
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="backward weights"):
        SF.fused_stem(x.clone().requires_grad_(True), sp)
    g5 = torch.randn(2, 8, 8, 128, generator=torch.Generator().manual_seed(2))
    xf = x.clone().requires_grad_(True)
    (SF.fused_stem(xf, sp, SF.stem_bwd_params(sp)) * g5).sum().backward()

    def conv(u, w, b, s):
        y = torch.nn.functional.conv2d(u, w.permute(3, 2, 0, 1), b, s,
                                       (w.shape[0] - 1) // 2)
        return torch.where(y > 0, y, 0.1 * y)
    xw = x.clone().requires_grad_(True)
    v = xw.permute(0, 3, 1, 2)
    y1 = conv(conv(v, *sp[0], 1), *sp[1], 2)
    y3 = conv(conv(y1, *sp[2], 1), *sp[3], 1)
    y5 = conv(y3 + y1, *sp[4], 2).permute(0, 2, 3, 1)
    (y5 * g5).sum().backward()
    scale = xw.grad.abs().max().item()
    torch.testing.assert_close(xf.grad, xw.grad, rtol=2e-5,
                               atol=2e-5 * scale)


# every weight the bfloat16 K1 (convs 1, 2, 3, 5: HWIO) and K2 (the five
# adjoints: stem_bwd_params) read in fragment order, as [kh, kw, K, N]
MMA_SHAPES = [(3, 3, 32, 64), (1, 1, 64, 32), (3, 3, 32, 64), (3, 3, 64, 128),
              (3, 3, 32, 8), (3, 3, 64, 32), (1, 1, 32, 64), (3, 3, 64, 32),
              (3, 3, 128, 64)]


@pytest.mark.parametrize("shape", MMA_SHAPES)
def test_mma_weights_are_the_fragments_mma_sync_reads(shape):
    """``mma_weights`` lays B out as m16n8k16's B fragments: lane 4g + t of
    step s and block j holds B[k][8j + g] at k = 16s + 2t + (0, 1, 8, 9);
    a GEMM summed fragment by fragment equals the conv's product."""
    kh, kw, k, n = shape
    g = torch.Generator().manual_seed(k * n + kh)
    w = torch.randn(*shape, generator=g)
    f = SF.mma_weights(w)
    assert f.shape == (kh * kw, k // 16, n // 8, 32, 4) and f.is_contiguous()
    lane = torch.arange(32)
    gi, ti = lane // 4, lane % 4
    taps = w.reshape(kh * kw, k, n)
    for e, dk in enumerate((0, 1, 8, 9)):
        for s in range(k // 16):
            for j in range(n // 8):
                torch.testing.assert_close(
                    f[:, s, j, :, e], taps[:, 16 * s + 2 * ti + dk, 8 * j + gi],
                    rtol=0, atol=0)
    # A [M, K] times each tap's B, fragment by fragment
    a = torch.randn(16, k, generator=g)
    want = a @ taps[0]
    got = torch.zeros(16, n)
    for s in range(k // 16):
        for j in range(n // 8):
            for e, dk in enumerate((0, 1, 8, 9)):
                kk = 16 * s + 2 * ti + dk
                # lane (g, t) adds A[:, kk] * B[kk][8j + g]: scatter to g
                contrib = a[:, kk] * f[0, s, j, :, e]
                got[:, 8 * j:8 * j + 8] += contrib.reshape(16, 8, 4).sum(-1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_mma_weights_built_once_per_weight_tensor():
    """The wrappers' fragment-order copy is made once per weight tensor and
    made again after the tensor changes in place."""
    w = torch.randn(3, 3, 32, 64, generator=torch.Generator().manual_seed(0))
    f = SF._mma_cached(w)
    assert SF._mma_cached(w) is f
    w.mul_(2)
    f2 = SF._mma_cached(w)
    assert f2 is not f
    torch.testing.assert_close(f2, 2 * f, rtol=0, atol=0)
    torch.testing.assert_close(f2, SF.mma_weights(w), rtol=0, atol=0)
    # weights made under inference mode (no version counter)
    with torch.inference_mode():
        wi = torch.ones(1, 1, 16, 8)
    fi = SF._mma_cached(wi)
    assert SF._mma_cached(wi) is fi
