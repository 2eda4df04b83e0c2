"""The batch-on-lanes stem (``experimental/stem_batched.py``: K8a's and
K8b's plain versions, the layout helpers and ``fused_stem_batched``)
against the JAX package's module, its XLA stem oracle and ``jax.vjp``, and
its Pallas kernels in interpret mode, at float32 on the CPU.

Tolerances: the layout helpers move bits and must be exact; the stem
agrees to rtol/atol 2e-5 (of the output scale for cotangents), the JAX
package's own for the same comparisons (``tests/test_stem_batched.py``):
both sides accumulate in float32, in different orders, over five chained
convs. Gradients are compared on ``sign_safe_mask`` pixels, outside the
receptive fields of ~0 pre-activations whose leaky gate the two orders
may set differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.experimental import stem_batched as JSB
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.experimental import stem_batched as SB
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF
from test_stem_fused import sign_safe_mask
from test_stem_fused import xla_stem as xla_stem_j
from test_torch_stem import make_sp, to_port


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


def _jsp(sp):
    return [(jnp.asarray(w), jnp.asarray(b)) for w, b in sp]


LAYOUT = {
    "nhwc_to_batched": (lambda m, x: m.nhwc_to_batched(x, 128),
                        (3, 8, 20, 5)),
    "batched_to_nhwc": (lambda m, p: m.batched_to_nhwc(p, 3, 20, 5),
                        (8, 7, 384)),
    "batched_to_nhwc_decimated": (
        lambda m, p: m.batched_to_nhwc(p, 2, 10, 4, lane0=1, stride=2),
        (6, 4, 256)),
    "split_phases_b": (lambda m, x: m.split_phases_b(x, 128),
                       (2, 8, 16, 3)),
    "merge_phases_b": (lambda m, p: m.merge_phases_b(p, p * 2, 2, 9, 3),
                       (5, 8, 256)),
    "interleave_zero_cols": (lambda m, g: m.interleave_zero_cols(g),
                             (2, 3, 4, 5)),
    "interleave_zero_rows": (lambda m, g: m.interleave_zero_rows(g),
                             (2, 3, 4, 5)),
}


@pytest.mark.parametrize("name", sorted(LAYOUT))
def test_layout_helper_matches_jax(name):
    fn, shape = LAYOUT[name]
    x = np.random.default_rng(3).random(shape).astype(np.float32)
    got = fn(SB, torch.from_numpy(x))
    want = fn(JSB, jnp.asarray(x))
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("w_vals,bsz", [(16, 2), (304, 3)])
def test_seg_and_lane_mask_match_jax(w_vals, bsz):
    seg = SB._seg(w_vals)
    assert seg == JSB._seg(w_vals)
    np.testing.assert_array_equal(SB._lane_mask(bsz, seg, w_vals).numpy(),
                                  np.asarray(JSB._lane_mask(bsz, seg,
                                                            w_vals)))


def _fwd(h, bsz, seed):
    rng = np.random.default_rng(seed)
    sp = make_sp(rng)
    x = rng.random((bsz, h, h, 3)).astype(np.float32)
    seg = SB._seg(h // 2)
    xe, xo = SB.split_phases_b(torch.from_numpy(x), seg)
    n = (SB.fused_stem_fwd_b.launches, SB.fused_stem_fwd_b.save_acts_launches)
    acts = SB.fused_stem_fwd_b(xe, xo, to_port(sp), bsz, save_acts=True)
    assert (SB.fused_stem_fwd_b.launches,
            SB.fused_stem_fwd_b.save_acts_launches) == n   # plain on the CPU
    return sp, x, seg, acts


@pytest.mark.parametrize("h,bsz", [(32, 2), (64, 3), (40, 1)])
def test_fwd_plain_matches_xla_oracle(h, bsz):
    """Decimated y5 and the five saved activations against the oracle's;
    the odd dense lanes against conv5 at strides (2, 1) on its s4."""
    sp, x, seg, acts = _fwd(h, bsz, 11)
    pre = []
    want = np.asarray(xla_stem_j(jnp.asarray(x), _jsp(sp),
                                 collect_preacts=pre))
    got = SB.batched_to_nhwc(acts[0], bsz, h // 4, 128, lane0=1, stride=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    leaky = [np.asarray(jnp.where(p > 0, p, 0.1 * p)) for p in pre]
    y0 = SB.merge_phases_b(acts[1], acts[2], bsz, h // 2, 32).numpy()
    np.testing.assert_allclose(y0, leaky[0], rtol=2e-5, atol=2e-5)
    for a, w in zip(acts[3:6], leaky[1:4]):
        g = SB.batched_to_nhwc(a, bsz, h // 2, w.shape[-1]).numpy()
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)
    s4 = jnp.asarray(leaky[3] + leaky[1])
    w5, b5 = _jsp(sp)[4]
    dense = lax.conv_general_dilated(
        s4, w5, (2, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=lax.Precision.HIGHEST) + b5
    dense = np.asarray(jnp.where(dense > 0, dense, 0.1 * dense))
    odd = SB.batched_to_nhwc(acts[0], bsz, h // 4, 128, lane0=2, stride=2)
    np.testing.assert_allclose(odd.numpy(), dense[:, :, 1::2], rtol=2e-5,
                               atol=2e-5)


def _gp5dd(acts, g5, bsz, h, seg):
    y5 = SB.batched_to_nhwc(acts[0], bsz, h // 4, 128, lane0=1, stride=2)
    gp5 = torch.from_numpy(g5) * torch.where(y5 > 0, 1.0, 0.1)
    return SB.nhwc_to_batched(SB.interleave_zero_rows(
        SB.interleave_zero_cols(gp5)), seg)


@pytest.mark.parametrize("h,bsz", [(32, 2), (64, 2), (40, 1)])
def test_bwd_plain_matches_xla_vjp(h, bsz):
    sp, x, seg, acts = _fwd(h, bsz, 11)
    g5 = np.random.default_rng(5).standard_normal(
        (bsz, h // 4, h // 4, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: xla_stem_j(v, _jsp(sp)), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g5))[0])
    psp = to_port(sp)
    n = SB.fused_stem_bwd_b.launches
    gxe, gxo = SB.fused_stem_bwd_b(_gp5dd(acts, g5, bsz, h, seg), acts,
                                   SF.stem_bwd_params(psp), bsz)
    assert SB.fused_stem_bwd_b.launches == n
    assert tuple(gxe.shape) == (h, 8, bsz * seg)
    got = SB.merge_phases_b(gxe, gxo, bsz, h // 2, 3).numpy()
    ok = sign_safe_mask(jnp.asarray(x), _jsp(sp))
    assert ok.mean() > 0.2
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5,
                               atol=2e-5 * scale)


def test_fused_stem_batched_matches_xla_vjp():
    rng = np.random.default_rng(7)
    sp = make_sp(rng)
    h = 32
    x = rng.random((2, h, h, 3)).astype(np.float32)
    g5 = rng.standard_normal((2, h // 4, h // 4, 128)).astype(np.float32)
    want_y, vjp = jax.vjp(lambda v: xla_stem_j(v, _jsp(sp)), jnp.asarray(x))
    want_g = np.asarray(vjp(jnp.asarray(g5))[0])
    psp = to_port(sp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = SB.fused_stem_batched(xt, psp, SF.stem_bwd_params(psp))
    y.backward(torch.from_numpy(g5))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=2e-5, atol=2e-5)
    ok = sign_safe_mask(jnp.asarray(x), _jsp(sp))
    assert ok.mean() > 0.2
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(xt.grad.numpy()[ok], want_g[ok], rtol=2e-5,
                               atol=2e-5 * scale)
    # without grad: the forward alone (K8a without save_acts), the same y5
    with torch.no_grad():
        assert torch.equal(SB.fused_stem_batched(xt, psp), y.detach())


@pytest.fixture(scope="module")
def pallas_case():
    """h=32, b=2: the Pallas kernels in interpret mode (forward with
    save_acts, then the backward on its own activations) and the port's
    plain versions on the same inputs."""
    sp, x, seg, acts = _fwd(32, 2, 13)
    g5 = np.random.default_rng(6).standard_normal(
        (2, 8, 8, 128)).astype(np.float32)
    gp5dd = _gp5dd(acts, g5, 2, 32, seg)
    je, jo = JSB.split_phases_b(jnp.asarray(x), seg)
    jacts = JSB.fused_stem_fwd_b(je, jo, _jsp(sp), bsz=2, interpret=True,
                                 save_acts=True)
    jgx = JSB.fused_stem_bwd_b(jnp.asarray(gp5dd.numpy()), jacts, _jsp(sp),
                               bsz=2, interpret=True)
    gx = SB.fused_stem_bwd_b(gp5dd, acts, SF.stem_bwd_params(to_port(sp)), 2)
    return acts, jacts, gx, jgx


def _whole(got, want):
    """Every element, border and slack lanes included."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max())


def test_fwd_plain_matches_pallas_interpret(pallas_case):
    acts, jacts, _, _ = pallas_case
    _whole(acts, jacts)


def test_bwd_plain_matches_pallas_interpret(pallas_case):
    _, _, gx, jgx = pallas_case
    _whole(gx, jgx)


def test_bf16_plain_rounds_like_the_fused_stem_plain():
    """In bfloat16 the saved activations carry K1's plain masks' signs
    exactly (the same convs and roundings), and the decimated y5 is K1's
    plain y5 to a bf16 rounding of its scale."""
    rng = np.random.default_rng(4)
    psp = to_port(make_sp(rng), torch.bfloat16)
    x = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32)).to(
        torch.bfloat16)
    acts = SB.fused_stem_fwd_b(*SB.split_phases_b(x, 128), psp, 2, True)
    assert all(a.dtype == torch.bfloat16 for a in acts)
    k1 = SF.fused_stem_fwd(*SF.split_phases(x), psp, save_acts=True)
    m0 = SB.merge_phases_b(acts[1], acts[2], 2, 16, 32) > 0
    assert torch.equal(m0, SF.merge_phases(k1[1], k1[2], 16, 32) > 0)
    for a, m, c in zip(acts[3:], k1[3:], (64, 32, 64)):
        assert torch.equal(SB.batched_to_nhwc(a, 2, 16, c) > 0,
                           SF.from_planar_plain(m, 16, c) > 0)
    y5 = SB.batched_to_nhwc(acts[0], 2, 8, 128, lane0=1, stride=2).float()
    want = SF.from_planar_plain(k1[0], 8, 128).float()
    assert (y5 - want).abs().max() <= 2.0 ** -7 * want.abs().max()


def test_shape_preconditions_raise():
    psp = to_port(make_sp(np.random.default_rng(1)))
    for shape in ((1, 36, 36, 3), (1, 32, 40, 3), (1, 32, 32, 4)):
        with pytest.raises(ValueError, match="fused_stem_batched"):
            SB.fused_stem_batched(torch.zeros(shape), psp)
    xe, xo = SB.split_phases_b(torch.zeros(2, 32, 32, 3), 128)
    with pytest.raises(ValueError, match="multiple of 8"):
        SB.fused_stem_fwd_b(xe, xo, psp, 3)
    with pytest.raises(ValueError, match="sbp"):
        SB.fused_stem_batched(torch.zeros(1, 32, 32, 3, requires_grad=True),
                              psp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interleaved_conv5_adjoint_is_the_stride2_adjoint(dtype):
    """The identity the bfloat16 K8b rests on: a gp5dd built as
    ``FusedStemBatched.backward`` builds it holds gp5 (r, c) at row 2r,
    lane 2c + 1 of each image's segment and zeros elsewhere, and on it the
    plain version's stride-1 conv5 adjoint equals
    ``conv_transpose2d(gp5, w5, stride=2, padding=1, output_padding=1)`` on
    the unexpanded gp5, which the kernel runs as K2's four parity GEMMs.
    Both sides hold the same products (the dense one adds exact zeros):
    in float64 they agree to 1e-12 of the scale, in float32 (the plain
    versions' accumulation) to 2e-5 of it, the summation orders apart."""
    F = torch.nn.functional
    rng = np.random.default_rng(9)
    bsz, h = 2, 32
    h1, h5, seg = h // 2, h // 4, SB._seg(h // 2)
    gp5 = torch.from_numpy(rng.standard_normal(
        (bsz, h5, h5, 128)).astype(np.float32)).to(dtype)
    w5 = SF.stem_bwd_params(to_port(make_sp(rng), dtype))[4]
    gp5dd = SB.nhwc_to_batched(SB.interleave_zero_rows(
        SB.interleave_zero_cols(gp5)), seg)
    lanes = gp5dd.reshape(h1, 128, bsz, seg).clone()
    data = lanes[0::2, :, :, 1:2 * h5:2]
    assert torch.equal(data.permute(2, 0, 3, 1), gp5)
    data.zero_()
    assert not lanes.any()
    # conv_transpose2d's weight [cin, cout, kh, kw], as the plain version's
    wt = w5.permute(2, 3, 0, 1)
    dense = SB.batched_to_nhwc(gp5dd, bsz, h1, 128).permute(0, 3, 1, 2)
    sparse = gp5.permute(0, 3, 1, 2)
    for acc, tol in ((torch.float64, 1e-12), (torch.float32, 2e-5)):
        got = F.conv_transpose2d(dense.to(acc), wt.to(acc), padding=1)
        want = F.conv_transpose2d(sparse.to(acc), wt.to(acc), stride=2,
                                  padding=1, output_padding=1)
        assert got.shape == want.shape == (bsz, 64, h1, h1)
        scale = want.abs().max().item()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                                   atol=tol * scale)
