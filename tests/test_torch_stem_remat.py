"""The stem's other two autograd Functions against the JAX package, at
float32 on the CPU: the recomputing backward (K5's plain version,
``fused_stem_remat``) and the planar-out stem (``fused_stem_planar``).

- ``fused_stem_bwd_plain`` against the Pallas ``fused_stem_bwd`` in
  interpret mode on the same x, y5 and g5, element for element, border and
  padding lanes included, at rtol 2e-5 of the output scale (float32 sums
  in other orders over the recompute and the chain);
- it equals K2's plain version on K1's plain masks exactly: the recompute
  is K1's forward, so K5 and K1 save_acts + K2 are the same function;
- both Functions' forward and input gradient against the XLA stem oracle
  and ``jax.vjp``, with ``sign_safe_mask`` excluding the receptive fields
  of ~0 pre-activations, at the JAX package's own 2e-5."""

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


def test_remat_bwd_plain_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    sp = make_sp(rng)
    h = 32
    x = rng.random((2, h, h, 3)).astype(np.float32)
    g5 = rng.standard_normal((2, h // 4, h // 4, 128)).astype(np.float32)
    je, jo = JSF.split_phases(jnp.asarray(x))
    y5 = JSF.fused_stem_fwd(je, jo, _jsp(sp), interpret=True)
    want = JSF.fused_stem_bwd(je, jo, y5, JSF.to_planar(jnp.asarray(g5)),
                              _jsp(sp), interpret=True)
    psp = to_port(sp)
    xe, xo = SF.split_phases(torch.from_numpy(x))
    n = SF.fused_stem_bwd.launches
    got = SF.fused_stem_bwd(xe, xo, torch.from_numpy(np.array(y5)),
                            PC.to_planar(torch.from_numpy(g5)), psp,
                            SF.stem_bwd_params(psp))
    assert SF.fused_stem_bwd.launches == n   # the plain version on the CPU
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape == (2, h, 8, 128)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * np.abs(w).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_bwd_plain_is_k2_on_k1_masks(dtype):
    rng = np.random.default_rng(4)
    psp = to_port(make_sp(rng), dtype)
    sbp = SF.stem_bwd_params(psp)
    x = torch.from_numpy(rng.random((1, 32, 32, 3), dtype=np.float32))
    xe, xo = SF.split_phases(x.to(dtype))
    g5p = PC.to_planar(torch.from_numpy(rng.standard_normal(
        (1, 8, 8, 128)).astype(np.float32)).to(dtype))
    acts = SF.fused_stem_fwd(xe, xo, psp, save_acts=True)
    want = SF.fused_stem_bwd_saved(acts, g5p, sbp)
    got = SF.fused_stem_bwd(xe, xo, acts[0], g5p, psp, sbp)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("variant", ["remat", "planar"])
def test_stem_variant_matches_xla_vjp(variant):
    rng = np.random.default_rng(7)
    sp = make_sp(rng)
    h = 32
    x = rng.random((2, h, h, 3)).astype(np.float32)
    g5 = rng.standard_normal((2, h // 4, h // 4, 128)).astype(np.float32)
    want_y, vjp = jax.vjp(lambda v: xla_stem(v, sp), jnp.asarray(x))
    want_g = np.asarray(vjp(jnp.asarray(g5))[0])
    psp = to_port(sp)
    sbp = SF.stem_bwd_params(psp)
    xt = torch.from_numpy(x).requires_grad_(True)
    if variant == "remat":
        y = SF.fused_stem_remat(xt, psp, sbp)
        y.backward(torch.from_numpy(g5))
    else:
        y5p = SF.fused_stem_planar(xt, psp, sbp)
        assert tuple(y5p.shape) == (2, h // 4, 128, 128)
        assert not y5p[..., 0].any() and not y5p[..., h // 4 + 1:].any()
        y5p.backward(PC.to_planar(torch.from_numpy(g5)))
        y = PC.from_planar(y5p, h // 4, 128)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=2e-5, atol=2e-5)
    got_g = xt.grad.numpy()
    ok = sign_safe_mask(jnp.asarray(x), _jsp(sp))
    assert ok.mean() > 0.2, "sign-safe mask degenerate"
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g[ok], want_g[ok], rtol=2e-5,
                               atol=2e-5 * scale)
    # without grad each is the forward alone, saving nothing
    with torch.no_grad():
        fn = SF.fused_stem_remat if variant == "remat" else \
            SF.fused_stem_planar
        assert torch.equal(fn(xt, psp), y.detach() if variant == "remat"
                           else y5p.detach())


def test_stem_variants_need_backward_weights():
    psp = to_port(make_sp(np.random.default_rng(1)))
    xt = torch.rand(1, 32, 32, 3).requires_grad_(True)
    for fn in (SF.fused_stem_remat, SF.fused_stem_planar):
        with pytest.raises(ValueError, match="sbp"):
            fn(xt, psp)
