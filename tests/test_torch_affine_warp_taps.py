"""The factored-warp kernel pair (``csrc/affine_warp.cu``) emulated in
numpy float32 on the CPU, as its threads compute: the forward takes each
hat's two taps floor(a) and floor(a) + 1 and recomputes the two mid values
an output reads; the backward walks each source position's X window and,
for each X whose weight is not 0, its Y window, with the kernel's window
bounds and margin. Each must agree with the plain version
(``affine_warp_mxu_plain``: dense hat matrices and ``torch.einsum``) and
its autograd, on the CPU, over the geometry the card tests cover: both
sides of the conditioning swap and an axis-aligned angle, the EOT's
smallest and largest zooms, a placement that clips at the canvas edge.

Tolerances: float32, 2e-6 forward (a two-term sum against the einsum's
FMA order) and 1e-5 of the gradient's largest magnitude backward (sums of
up to ~25 taps in another order); bfloat16, one bf16 ulp of each plain
value forward (where the einsum rounds a product sum the same, bit-equal
almost everywhere) and 2^-7 of the gradient's largest magnitude backward
(a sum order may flip a rounding of the bf16 mid cotangent)."""

import math

import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import eot as PE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import affine as PA
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import affine_mxu as PAM

F32 = np.float32


@pytest.fixture(autouse=True)
def _grad_enabled():
    with torch.enable_grad():
        yield


def zoom_range(p, s):
    """The EOT's zooms: the largest it draws (``max_zoom_window``'s) and
    the smallest, from the empty-scene reference row (0.25)."""
    largest = math.sqrt(2.0) * s / (2.0 * p)
    smallest = math.sqrt(2.0) * 0.25 * s / (2.0 * p)
    return smallest, largest


def warp_cases(p, s):
    """(angle, zoom, cx, cy) rows for a p-pixel patch on an s canvas."""
    lo, hi = zoom_range(p, s)
    return [(0.0, 1.0, 0.5, 0.5),            # axis-aligned
            (0.4, hi, 0.45, 0.55),           # rotated, no swap, largest zoom
            (math.pi / 2 - 0.3, 1.3, 0.5, 0.5),   # swap
            (-2.5, lo, 0.6, 0.4),            # no swap, cos < 0, smallest zoom
            (2.0, hi, 0.2, 0.8),             # swap, clipped at the edge
            (-1.9, 0.9 * hi, 0.02, 0.97)]    # swap, far past the edge


def warp_theta(p, s, b=6, seed=0, extra=()):
    """theta [b, 2, 3] as ``warp_patch`` builds it (centres normalized to
    the canvas), cycling through ``warp_cases`` and then ``extra`` rows;
    past the first cycle each angle is jittered by U(-0.2, 0.2) from
    ``seed``. The card tests and ``chip_smoke.py`` draw theirs here."""
    cases = warp_cases(p, s) + list(extra)
    rows = [cases[i % len(cases)] for i in range(b)]
    jitter = np.where(np.arange(b) < len(cases), 0.0,
                      np.random.default_rng(seed).uniform(-0.2, 0.2, b))
    a, z, cx, cy = (torch.tensor(np.array(v, F32)) for v in zip(*rows))
    a = a + torch.from_numpy(jitter.astype(F32))
    return PA.rotation_scale_translation_theta(a, z, (0.5 - cx) * 2.0,
                                               (0.5 - cy) * 2.0)


def rnd(a, dt):
    """float32 array rounded to ``dt`` (the warp dtype), as float32."""
    if dt == torch.float32:
        return a.astype(F32)
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(dt).float() \
        .numpy()


def coeffs(theta, out_hw, src_hw, offset):
    """The kernels' coefficient table (``_kernel_coeffs``) as columns: p,
    q, u1, r, s, v and the swap flag."""
    k = PAM._kernel_coeffs(theta, out_hw, src_hw, offset).numpy()
    return [k[:, i] for i in range(6)] + [k[:, 6] != 0]


def hat_w(a, tap, dt):
    t = (a - F32(tap)).astype(F32)
    return rnd(np.maximum((F32(1.0) - np.abs(t)).astype(F32), F32(0.0)), dt)


def emulate_forward(img, theta, out_hw, src_hw, offset, dt):
    """The forward kernel's threads, vectorized over (b, Y, X)."""
    b, n, _, c = img.shape
    oh, ow = out_hw
    p, q, u1, r, s, v, swap = coeffs(theta, out_hw, src_hw, offset)
    src_t = np.where(swap[:, None, None, None], img.transpose(0, 2, 1, 3),
                     img).astype(F32)
    src4 = np.concatenate([src_t, np.ones((b, n, n, 1), F32)], -1)
    Y = np.arange(oh, dtype=F32)[None, :, None]
    X = np.arange(ow, dtype=F32)[None, None, :]
    col = lambda t: t[:, None, None]  # noqa: E731
    aY = ((col(r) * X) + (col(s) * Y)) + col(v)
    acc = np.zeros((b, oh, ow, c + 1), F32)
    bi = np.arange(b)[:, None, None]
    reach = (aY > -1) & (aY < n)
    y0 = np.floor(np.where(reach, aY, 0)).astype(np.int64)
    for ky in (0, 1):
        y = y0 + ky
        wy = hat_w(aY, y, dt)
        ok_y = reach & (y >= 0) & (y < n) & (wy != 0)
        yc = np.clip(y, 0, n - 1)
        aX = ((col(p) * X) + (col(q) * yc.astype(F32))) + col(u1)
        reach_x = (aX > -1) & (aX < n)
        x0 = np.floor(np.where(reach_x, aX, 0)).astype(np.int64)
        m = np.zeros_like(acc)
        for kx in (0, 1):
            x = x0 + kx
            ok = reach_x & (x >= 0) & (x < n)
            wx = hat_w(aX, x, dt)
            vals = src4[bi, yc, np.clip(x, 0, n - 1)]
            m = np.where(ok[..., None], (m + wx[..., None] * vals).astype(F32),
                         m)
        acc = np.where(ok_y[..., None],
                       (acc + wy[..., None] * rnd(m, dt)).astype(F32), acc)
    return rnd(acc, dt)


def window(slope, off, t, n):
    """The kernel's ``window``: candidate k in [lo, hi]."""
    slack = F32(1) + F32(1e-3) * (abs(off) + abs(t) + abs(slope) * F32(n)
                                  + F32(1))
    with np.errstate(divide="ignore", invalid="ignore"):
        e1 = (t - slack - off) / slope
        e2 = (t + slack - off) / slope
    a, b = min(e1, e2), max(e1, e2)
    if not a <= b:
        return 0, n - 1
    a = min(max(float(np.floor(a)) - 1.0, 0.0), float(n))
    b = max(min(float(np.ceil(b)) + 1.0, float(n - 1)), -1.0)
    return int(a), int(b)


def emulate_backward(g, theta, src_shape, out_hw, src_hw, offset, dt):
    """The backward kernel's threads, one source position at a time."""
    b, n, _, c = src_shape
    oh, ow = out_hw
    p, q, u1, r, s, v, swap = coeffs(theta, out_hw, src_hw, offset)
    gsrc = np.zeros(src_shape, F32)
    for bi in range(b):
        for y in range(n):
            fy = F32(y)
            for x in range(n):
                acc = np.zeros(c, F32)
                lo, hi = window(p[bi], F32(q[bi] * fy) + u1[bi], F32(x), ow)
                for X in range(lo, hi + 1):
                    fX = F32(X)
                    wx = hat_w((p[bi] * fX + q[bi] * fy) + u1[bi], x, dt)
                    if wx == 0:
                        continue
                    gm = np.zeros(c, F32)
                    ylo, yhi = window(s[bi], F32(r[bi] * fX) + v[bi], fy, oh)
                    for Y in range(ylo, yhi + 1):
                        a = (r[bi] * fX + s[bi] * F32(Y)) + v[bi]
                        wy = hat_w(a, y, dt)
                        if wy != 0:
                            gm = (gm + wy * g[bi, Y, X]).astype(F32)
                    acc = (acc + wx * rnd(gm, dt)).astype(F32)
                row, col = (x, y) if swap[bi] else (y, x)
                gsrc[bi, row, col] = rnd(acc, dt)
    return gsrc


def plain(img, theta, out_hw, offset, dt, g, g_mask):
    it = torch.from_numpy(img).to(dt).requires_grad_(True)
    out, mask = PAM.affine_warp_mxu_plain(it, theta, out_hw, out_hw, offset)
    (out.float() * torch.from_numpy(g)).sum().backward(retain_graph=True)
    grad = it.grad.float().numpy().copy()
    it.grad = None
    (out.float() * torch.from_numpy(g)).sum().add(
        (mask.float() * torch.from_numpy(g_mask)).sum()).backward()
    grad_m = it.grad.float().numpy()
    return (out.detach().float().numpy(), mask.detach().float().numpy(),
            grad, grad_m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,s", [(13, 40), (6, 16)])
def test_emulated_kernels_match_the_plain_warp(dtype, p, s):
    rng = np.random.default_rng(5 + p)
    theta = warp_theta(p, s)
    b = theta.shape[0]
    pad = (s - p) // 2
    img = rng.random((b, p, p, 3)).astype(F32)
    g = rng.standard_normal((b, s, s, 3)).astype(F32)
    g_mask = rng.standard_normal((b, s, s, 1)).astype(F32)
    out, mask, grad, grad_m = plain(img, theta, (s, s), (pad, pad), dtype,
                                    g, g_mask)
    assert mask.max() > 0.99 and (mask == 0).any()
    src = rnd(img, dtype)
    got = emulate_forward(src, theta, (s, s), (s, s), (pad, pad), dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(got[..., :3], out, rtol=0, atol=2e-6)
        np.testing.assert_allclose(got[..., 3:], mask, rtol=0, atol=2e-6)
    else:
        # one bf16 ulp of each plain value (8 bits of mantissa)
        for k, want in ((slice(0, 3), out), (slice(3, 4), mask)):
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert (np.abs(got[..., k] - want) <= ulp).all()
            assert (got[..., k] == want).mean() > 0.99
    gsrc = emulate_backward(rnd(g, dtype), theta, img.shape, (s, s),
                            (s, s), (pad, pad), dtype)
    # the mask's cotangent does not reach the patch
    np.testing.assert_array_equal(grad_m, grad)
    scale = np.abs(grad).max()
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale
    np.testing.assert_allclose(gsrc, grad, rtol=0, atol=tol)
    assert (np.abs(gsrc) > 0).mean() > 0.3


@pytest.mark.parametrize("p,s", [(13, 40), (224, 608), (224, 416)])
def test_kernel_coefficients_are_the_plain_ones_bit_for_bit(p, s):
    """The coefficient table the kernels read holds ``_factored_coeffs``'
    (the plain warp's) bit for bit, in the kernels' column order, swap and
    all, a near-singular zoom included."""
    theta = warp_theta(p, s, b=7, extra=[(0.0, 1e-13, 0.5, 0.5)])
    pad = (s - p) // 2
    got = coeffs(theta, (s, s), (s, s), (pad, pad))
    swap, *want = PAM._factored_coeffs(theta, (s, s), (s, s), (pad, pad))
    np.testing.assert_array_equal(got[-1], swap.numpy())
    for g, w in zip(got[:-1], want):
        np.testing.assert_array_equal(g.view(np.int32),
                                      w.numpy().view(np.int32))


@pytest.mark.parametrize("slope,off,t,n", [
    (0.7, 3.2, 5.0, 40), (-1.3, 30.0, 2.0, 40), (0.0, 1.5, 2.0, 16),
    (0.0, 9.0, 2.0, 16), (1e-6, -3.0, 0.0, 608), (2.5, -500.0, 11.0, 608)])
def test_window_holds_every_non_zero_tap(slope, off, t, n):
    """Every k in [0, n) whose float32 hat |slope k + off - t| < 1 is
    non-zero lies in the kernel's window."""
    sl, of, tt = F32(slope), F32(off), F32(t)
    k = np.arange(n, dtype=F32)
    w = hat_w((sl * k + of).astype(F32), int(t), torch.float32)
    lo, hi = window(sl, of, tt, n)
    live = np.nonzero(w)[0]
    assert ((live >= lo) & (live <= hi)).all(), (live, lo, hi)


def test_eot_zoom_range_is_the_eot_config():
    """The tests' largest zoom is the one ``max_zoom_window`` covers."""
    lo, hi = zoom_range(224, 608)
    assert math.ceil(hi * math.sqrt(2.0)) + 1 == PE.max_zoom_window(608, 224)
    assert lo < hi


def test_cpu_takes_the_plain_warp_and_launches_nothing():
    """On CPU tensors ``affine_warp_mxu`` is the plain version, forward
    and backward, and neither kernel counter moves; the counters are
    ``kernel_launches``' entries."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import ops
    before = ops.kernel_launches()
    assert (before["affine_warp_mxu"], before["affine_warp_mxu_bwd"]) == (
        PAM.affine_warp_mxu.launches, PAM.affine_warp_mxu.bwd_launches)
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.random((3, 6, 6, 3)).astype(F32))
    theta = warp_theta(6, 16, b=3)
    grads = []
    for fn in (PAM.affine_warp_mxu, PAM.affine_warp_mxu_plain):
        it = img.clone().requires_grad_(True)
        out, mask = fn(it, theta, (16, 16), (16, 16), (5, 5))
        (out * 2.0).sum().add(mask.sum()).backward()
        grads.append((out.detach(), mask.detach(), it.grad))
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    assert ops.kernel_launches() == before


def test_kernel_wrapper_passes_the_kernels_their_shapes(monkeypatch):
    """On meta tensors, with ``_cuda.launch`` recording: one forward
    launch with the source's and the canvas's sizes and the coefficient
    table of theta's geometry, built once (``_kernel_coeffs``), then one
    backward launch with the [B, oh, ow, C]
    cotangent of the warped channels; the outputs are two views of one
    [B, oh, ow, C+1] buffer, the mask carrying no gradient. Each launch
    counts once. Without the stub a meta tensor raises."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
    assert set(_cuda.SIGNATURES["affine_warp"]) == {
        "apfp_affine_warp_fwd", "apfp_affine_warp_bwd"}
    img = torch.empty(5, 7, 7, 3, dtype=torch.bfloat16, device="meta",
                      requires_grad=True)
    theta = torch.empty(5, 2, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        PAM.affine_warp_mxu(img, theta, (20, 22))
    calls, tables = [], []
    kernel_coeffs = PAM._kernel_coeffs
    monkeypatch.setattr(PAM, "_kernel_coeffs", lambda *a: tables.append(
        a[1:]) or kernel_coeffs(*a))
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "launch", lambda what, name, entry, t, *a:
                        calls.append((what, name, entry, t.shape, a[3:])))
    n = (PAM.affine_warp_mxu.launches, PAM.affine_warp_mxu.bwd_launches)
    out, mask = PAM.affine_warp_mxu(img, theta, (20, 22), src_hw=(30, 30),
                                    offset=(6, 7))
    assert out.shape == (5, 20, 22, 3) and mask.shape == (5, 20, 22, 1)
    assert out._base is mask._base and out._base.shape == (5, 20, 22, 4)
    assert out.requires_grad and not mask.requires_grad
    (out.float().sum() + mask.float().sum()).backward()
    assert tables == [((20, 22), (30, 30), (6, 7))]
    bf16 = _cuda.DTYPE_CODES[torch.bfloat16]
    assert calls == [
        ("affine_warp_mxu", "affine_warp", "apfp_affine_warp_fwd",
         (5, 7, 7, 3), (bf16, 5, 7, 20, 22)),
        ("affine_warp_mxu_bwd", "affine_warp", "apfp_affine_warp_bwd",
         (5, 20, 22, 3), (bf16, 5, 7, 20, 22))]
    assert img.grad.shape == img.shape and img.grad.dtype == torch.bfloat16
    assert (PAM.affine_warp_mxu.launches,
            PAM.affine_warp_mxu.bwd_launches) == (n[0] + 1, n[1] + 1)
    with pytest.raises(ValueError, match="channels"):
        PAM.affine_warp_mxu(torch.empty(1, 4, 4, 1, device="meta"),
                            theta[:1], (8, 8))
    with pytest.raises(ValueError, match="theta"):
        PAM.affine_warp_mxu(img, theta[:2], (8, 8))
