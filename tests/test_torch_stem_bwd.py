"""The fused stem's training half: K1's ``save_acts`` masks and K2's plain
version against the JAX package, at float32 on the CPU.

- masks: equal to the Pallas ``fused_stem_fwd(save_acts=True)`` in
  interpret mode, element for element, border and padding lanes included
  (a sign flip is allowed only where the pre-activation is ~0, where the
  two sides' summation orders may round it to different signs);
- ``fused_stem_bwd_saved_plain``: against ``jax.vjp`` of the XLA stem,
  with ``sign_safe_mask`` excluding the receptive fields of ~0
  pre-activations, at rtol 2e-5 (the JAX package's own tolerance for its
  kernels against the same oracle), and against the Pallas
  ``fused_stem_bwd_saved`` in interpret mode on the same masks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import stem_fused as JSF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF
from test_stem_fused import sign_safe_mask
from test_torch_stem import make_sp, to_port, xla_stem


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


def _jsp(sp):
    return [(jnp.asarray(w), jnp.asarray(b)) for w, b in sp]


def test_save_acts_masks_match_pallas_interpret():
    rng = np.random.default_rng(7)
    sp = make_sp(rng)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    je, jo = JSF.split_phases(jnp.asarray(x))
    want = JSF.fused_stem_fwd(je, jo, _jsp(sp), interpret=True,
                              save_acts=True)
    xe, xo = SF.split_phases(torch.from_numpy(x))
    got = SF.fused_stem_fwd(xe, xo, to_port(sp), save_acts=True)
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-5, atol=2e-5)
    flips = 0
    for g, w in zip(got[1:], want[1:]):
        w = np.asarray(w)
        assert g.dtype == torch.int8 and tuple(g.shape) == w.shape
        flips += int((g.numpy() != w).sum())
        assert not g[..., 0].any() and not g[..., 17:].any()
    assert flips <= 2, flips


def test_save_acts_is_the_forward_plus_masks():
    rng = np.random.default_rng(3)
    sp = to_port(make_sp(rng))
    x = torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32))
    xe, xo = SF.split_phases(x)
    acts = SF.fused_stem_fwd(xe, xo, sp, save_acts=True)
    assert torch.equal(acts[0], SF.fused_stem_fwd(xe, xo, sp))
    shapes = [tuple(a.shape) for a in acts[1:]]
    assert shapes == [(1, 32, 32, 128)] * 2 + [(1, 16, 64, 128),
                                               (1, 16, 32, 128),
                                               (1, 16, 64, 128)]


@pytest.mark.parametrize("h", [32, 64])
def test_bwd_plain_matches_xla_vjp(h):
    rng = np.random.default_rng(7)
    sp = make_sp(rng)
    x = rng.random((2, h, h, 3)).astype(np.float32)
    g5 = rng.standard_normal((2, h // 4, h // 4, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: xla_stem(v, sp), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g5))[0])
    psp = to_port(sp)
    xe, xo = SF.split_phases(torch.from_numpy(x))
    acts = SF.fused_stem_fwd(xe, xo, psp, save_acts=True)
    gxe, gxo = SF.fused_stem_bwd_saved(
        acts, PC.to_planar(torch.from_numpy(g5)), SF.stem_bwd_params(psp))
    assert gxe.shape == (2, h, 8, 128)
    assert not gxe[:, :, 3:].any() and not gxo[..., h // 2 + 1:].any()
    got = SF.merge_phases(gxe, gxo, h // 2, 3).numpy()
    ok = sign_safe_mask(jnp.asarray(x), _jsp(sp))
    assert ok.mean() > 0.2, "sign-safe mask degenerate"
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5,
                               atol=2e-5 * scale)


def test_bwd_plain_matches_pallas_interpret_on_the_same_masks():
    rng = np.random.default_rng(5)
    sp = make_sp(rng)
    h = 32
    x = rng.random((2, h, h, 3)).astype(np.float32)
    g5 = rng.standard_normal((2, h // 4, h // 4, 128)).astype(np.float32)
    je, jo = JSF.split_phases(jnp.asarray(x))
    jacts = JSF.fused_stem_fwd(je, jo, _jsp(sp), interpret=True,
                               save_acts=True)
    want = JSF.fused_stem_bwd_saved(jacts, JSF.to_planar(jnp.asarray(g5)),
                                    _jsp(sp), interpret=True)
    acts = [torch.from_numpy(np.array(a)) for a in jacts]
    got = SF.fused_stem_bwd_saved(acts, PC.to_planar(torch.from_numpy(g5)),
                                  SF.stem_bwd_params(to_port(sp)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max())


def test_bwd_plain_bf16_rounds_at_the_kernel_points():
    """In bfloat16 the plain backward's output is bf16, and a float32
    run of the same chain on bf16-valued inputs agrees with it to a few
    bf16 ulps of the output scale (rounding points only)."""
    rng = np.random.default_rng(9)
    sp = make_sp(rng)
    x = torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32))
    g5 = torch.from_numpy(rng.standard_normal((1, 8, 8, 128)).astype(
        np.float32))
    spb = to_port(sp, torch.bfloat16)
    xe, xo = SF.split_phases(x.bfloat16())
    acts = SF.fused_stem_fwd(xe, xo, spb, save_acts=True)
    gb = SF.fused_stem_bwd_saved(acts, PC.to_planar(g5.bfloat16()),
                                 SF.stem_bwd_params(spb))
    assert all(g.dtype == torch.bfloat16 for g in gb)
    acts32 = [acts[0].float(), *acts[1:]]
    g32 = SF.fused_stem_bwd_saved(
        acts32, PC.to_planar(g5.bfloat16().float()),
        [v.float() for v in SF.stem_bwd_params(spb)])
    for a, b in zip(gb, g32):
        scale = b.abs().max().item()
        assert (a.float() - b).abs().max().item() <= 2.0 ** -5 * scale


def test_bwd_wrapper_refuses_bad_weights_on_cpu_shapes():
    """The weight check the CUDA path runs (``_check_stem_bwd_params``)
    rejects a wrong shape or dtype."""
    rng = np.random.default_rng(1)
    sbp = SF.stem_bwd_params(to_port(make_sp(rng)))
    assert [tuple(v.shape) for v in sbp] == list(SF.STEM_BWD_SHAPES)
    SF._check_stem_bwd_params(sbp, torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError, match="weight"):
        SF._check_stem_bwd_params(sbp[:4] + [sbp[4].t().contiguous()
                                              if sbp[4].dim() == 2 else
                                              sbp[4][..., :32]],
                                  torch.float32, torch.device("cpu"))
    with pytest.raises(ValueError, match="weight"):
        SF._check_stem_bwd_params(sbp, torch.bfloat16, torch.device("cpu"))
