"""The bfloat16 K4's weights as its ``wgmma`` kernel streams them, on the
CPU.

``ops/planar_conv.py: k4_plan`` picks a launch's channel width ``n`` (the
wgmma N: 8, 16, 32 or 64; the adjoint at most 32) and its 16-deep steps
a channel chunk ``ns`` (1 at stride 2 or up to a depth of 16, 2 up to 32,
then 4), as ``csrc/planar_conv.cu: wgk::plan`` does; ``k4_weights``
packs an HWIO kernel for that plan into the chunks the kernel copies into
shared memory as they are. Input channel ``c kc + i`` (``kc = 16 ns``) of
tap t (row-major) and output channel ``cb n + j`` lie in chunk
``(cb nck + c) wpc + (t kc + i) // 64`` (``wpc = ceil(k^2 ns / 4)``) at
byte

    j * 128 + ((((t kc + i) % 64) // 8) ^ (j % 8)) * 16 + (i % 8) * 2

and every other byte is zero (cin padded to ``nck`` chunks, cout to
``n_cb n``, the last chunk of each channel chunk past its taps). Here
each variant's packed weights, at the planar routes' widths and at odd
ones, from numpy-seeded weights, are unpacked by that formula alone and
must give back the weights exactly; the kernel's sum, emulated on the
unpacked weights (taps in row-major order; the adjoint's tap (dy, dx) on
parity (dy != 1, dx != 1), reading g at (a + [dy == 2], b + [dx == 2])),
must equal the plain versions; and the packed copies are built once per
weight tensor and plan.
"""

import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF


def k4_unpack(packed, k, cin, cout, ns, n):
    """[k*k, cin, cout] uint16 (the bfloat16 bits) from ``k4_weights``'
    output by the documented formula, and the bytes no element maps to."""
    raw = packed.contiguous().view(torch.uint8).reshape(-1).numpy()
    kc = 16 * ns
    nck = -(-PC._round_up(cin, 16) // kc)
    wpc = -(-(k * k * ns) // 4)
    n_cb = -(-cout // n)
    assert raw.size == n_cb * nck * wpc * n * 128
    t = np.arange(k * k)[:, None, None]
    ci = np.arange(cin)[None, :, None]
    co = np.arange(cout)[None, None, :]
    c, i = ci // kc, ci % kc
    cb, j = co // n, co % n
    d = t * kc + i
    off = (((cb * nck + c) * wpc + d // 64) * n * 128 + j * 128
           + (((d % 64) // 8) ^ (j % 8)) * 16 + (i % 8) * 2)
    got = raw[off].astype(np.uint16) | (raw[off + 1].astype(np.uint16) << 8)
    used = np.zeros(raw.size, bool)
    used[off] = used[off + 1] = True
    return got, raw[~used]


def _bits(w):
    return w.contiguous().view(torch.int16).numpy().astype(np.uint16)


def _weights(k, cin, cout, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(2 / (k * k * cin))
    return torch.tensor(w, dtype=torch.bfloat16)


@pytest.mark.parametrize("k,stride,cin,cout,plan", [
    (3, 1, 3, 32, (1, 32, 1, 16)), (3, 2, 32, 64, (1, 64, 1, 32)),
    (1, 1, 64, 32, (4, 32, 1, 64)), (3, 1, 32, 64, (2, 64, 1, 32)),
    (3, 2, 64, 128, (1, 64, 2, 64)), (3, 1, 64, 128, (4, 64, 2, 64)),
    (1, 1, 128, 64, (4, 64, 1, 128)), (3, "t2", 128, 64, (4, 32, 2, 128)),
    (3, "t2", 64, 32, (4, 32, 1, 64)), (3, "t2", 24, 12, (2, 16, 1, 32)),
    (3, 1, 136, 40, (4, 64, 1, 144)), (1, 1, 33, 200, (4, 64, 4, 48))])
def test_k4_plan_is_the_kernels_rule(k, stride, cin, cout, plan):
    """(ns, n, n_cb, kdepth) of ``k4_plan``: the least width that holds
    cout (at most 64; the adjoint 32), one step a chunk at stride 2 or up
    to a depth of 16, two up to 32 and four past it."""
    assert PC.k4_plan(k, stride, cin, cout) == plan


# (k, stride, cin, cout): the planar stem's and stage's convs forward and
# backward, the slim victim's stem, and widths that are multiples of
# neither 16 nor 8
LAYOUT_CASES = [
    (3, 1, 3, 32), (3, 2, 32, 64), (1, 1, 64, 32), (3, 1, 32, 64),
    (3, 2, 64, 128), (1, 1, 128, 64), (3, 1, 64, 128), (3, 1, 128, 64),
    (1, 1, 64, 128), (3, "t2", 128, 64), (3, "t2", 64, 32),
    (3, 1, 32, 8), (3, 1, 8, 16), (3, 2, 16, 32), (3, 1, 20, 12),
    (3, 2, 72, 128), (3, 1, 136, 40), (1, 1, 33, 200), (3, "t2", 40, 12)]


@pytest.mark.parametrize("k,stride,cin,cout", LAYOUT_CASES)
def test_k4_weights_unpack_by_the_documented_formula(k, stride, cin, cout):
    """Each variant's packed weights: shape ``[n_cb nck wpc, n, 64]``
    bfloat16; the formula gives back every weight (taps row-major, cin
    and cout in their chunks and blocks) and every other byte is zero."""
    ns, n, n_cb, _ = PC.k4_plan(k, stride, cin, cout)
    w = _weights(k, cin, cout, cin * 1000 + cout + k)
    packed = PC.k4_weights(w, ns, n)
    nck = -(-PC._round_up(cin, 16) // (16 * ns))
    wpc = -(-(k * k * ns) // 4)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (n_cb * nck * wpc, n, 64)
    got, rest = k4_unpack(packed, k, cin, cout, ns, n)
    assert np.array_equal(got, _bits(w.reshape(k * k, cin, cout)))
    assert not rest.any()


def _unpacked(w, k, stride):
    """The weights as the kernel reads them, [k*k, cin, cout] float64."""
    _, _, cin, cout = w.shape
    ns, n, _, _ = PC.k4_plan(k, stride, cin, cout)
    got, _ = k4_unpack(PC.k4_weights(w, ns, n), k, cin, cout, ns, n)
    return torch.from_numpy(got.astype(np.int16)).view(
        torch.bfloat16).double()


@pytest.mark.parametrize("k,stride,cin,cout", [
    (3, 1, 20, 12), (3, 2, 16, 24), (1, 1, 40, 16)])
def test_k4_forward_sum_on_the_packed_weights_is_the_conv(k, stride, cin,
                                                         cout):
    """Output (r, c) of a forward conv sums tap t = 3 ky + kx of the
    unpacked weights against x at (S r + ky - P, S c + kx - P): the
    plain version's conv (float64, before its roundings)."""
    g = torch.Generator().manual_seed(cin + cout)
    h = 12
    x = torch.randn(1, h, h, cin, generator=g).to(torch.bfloat16)
    w = _weights(k, cin, cout, 7)
    wt = _unpacked(w, k, stride)
    p = (k - 1) // 2
    xd = torch.nn.functional.pad(x.double(), (0, 0, p, p, p, p))
    ho = h // stride
    want = torch.nn.functional.conv2d(
        x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
        None, stride, p).permute(0, 2, 3, 1)
    got = torch.zeros(1, ho, ho, cout, dtype=torch.float64)
    for t in range(k * k):
        ky, kx = divmod(t, k)
        win = xd[:, ky:ky + stride * ho:stride, kx:kx + stride * ho:stride]
        got += win @ wt[t]
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("cin,cout", [(24, 12), (128, 64), (64, 32)])
def test_k4_adjoint_parities_on_the_packed_weights(cin, cout):
    """The adjoint's parity rule covers each of the nine taps once (1, 2,
    2 and 4 a parity, K2's ``T2_PARITY_TAPS``), and its sum on the
    unpacked flipped kernel equals ``planar_conv_t2_plain`` (bias 0, no
    gate) within float32 rounding."""
    sets = {}
    for t in range(9):
        dy, dx = divmod(t, 3)
        sets.setdefault((int(dy != 1), int(dx != 1)), []).append((dy, dx))
    assert [sorted(sets[(py, px)]) for py in (0, 1) for px in (0, 1)] == \
        [sorted(taps) for taps in SF.T2_PARITY_TAPS]
    assert sorted(len(v) for v in sets.values()) == [1, 2, 2, 4]
    g = torch.Generator().manual_seed(cin)
    hg = 6
    gn = torch.randn(1, hg, hg, cin, generator=g).to(torch.bfloat16)
    w_t = _weights(3, cin, cout, 3)
    wt = _unpacked(w_t, 3, "t2")
    gd = torch.nn.functional.pad(gn.double(), (0, 0, 0, 1, 0, 1))
    got = torch.zeros(1, 2 * hg, 2 * hg, cout, dtype=torch.float64)
    for (py, px), taps in sets.items():
        for dy, dx in taps:
            ey, ex = int(dy == 2), int(dx == 2)
            got[:, py::2, px::2] += gd[:, ey:ey + hg, ex:ex + hg] @ \
                wt[3 * dy + dx]
    want = PC.planar_conv_t2_plain(PC.to_planar(gn.float()), w_t.float(),
                                   torch.zeros(cout), w_img=hg)
    want = PC.from_planar_plain(want, 2 * hg, cout)
    assert torch.allclose(got.float(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,stride,cin,cout", [
    (3, 1, 64, 128), (3, "t2", 128, 64)])
def test_k4_weights_built_once_per_weight_tensor_and_plan(k, stride, cin,
                                                          cout):
    """``_kernel_weights`` packs a weight tensor once per plan (the
    builder of a plan is one object), again after an in-place change, and
    leaves the ``mma.sync`` fragment copy of the same tensor alone."""
    w = _weights(k, cin, cout, 11)
    xp = torch.zeros(1, 4, cin, 128, dtype=torch.bfloat16)
    b = torch.zeros(cout)
    wk, _, cout_pad, kdepth = PC._kernel_weights("t", xp, w, b, stride)
    ns, n, n_cb, kd = PC.k4_plan(k, stride, cin, cout)
    assert (cout_pad, kdepth) == (n_cb * n, kd)
    assert PC._k4_builder(ns, n) is PC._k4_builder(ns, n)
    assert PC._kernel_weights("t", xp, w, b, stride)[0] is wk
    m = PC._mma_cached(w)
    assert m is not wk and PC._kernel_weights("t", xp, w, b, stride)[0] is wk
    w.mul_(2)
    wk2 = PC._kernel_weights("t", xp, w, b, stride)[0]
    assert wk2 is not wk and torch.equal(wk2, PC.k4_weights(w, ns, n))
