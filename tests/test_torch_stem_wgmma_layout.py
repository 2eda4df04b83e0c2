"""The bfloat16 K1 and K2 weights as their ``wgmma`` kernels stream them,
on the CPU.

``ops/stem_fused.py: wg_weights`` packs one GEMM's weights ``[T, K, N]``
into chunks ``[NCH, N, 64]`` whose bytes the kernels copy into shared
memory as they are; ``wgmma`` reads them through a K-major descriptor
with the 128-byte swizzle (``csrc/stem_common.cuh: wg``). Element (k, n)
of the GEMM's depth-by-width matrix (k over taps, then channels) lies in
chunk ``k // 64`` at byte

    n * 128 + (((k % 64) // 8) ^ (n % 8)) * 16 + (k % 8) * 2

and every byte past the depth is zero. Here each of K1's five convs and
K2's five swapped-channel adjoints, at the stem's full widths, in
bfloat16, from numpy-seeded HWIO weights, is packed by the port and
unpacked by that formula alone, and must give back the weights exactly:
K1's conv0 in ``RowsConv0``'s paired taps (channels 3 -> 8, a zero
fourth column), convs 1, 2, 3 and 5 and K2's conv0ᵀ, conv2ᵀ and conv3ᵀ
in row-major tap order, K2's conv1ᵀ and conv5ᵀ one GEMM per output parity
in ``RowsT2``'s tap order, the four back to back. The packed copies are
built once per weight tensor, as ``_mma_cached`` builds the fragment
order.
"""

import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF


def _stem_params(seed=5):
    """K1's (HWIO bfloat16 weight, float32 bias) pairs, from numpy."""
    rng = np.random.default_rng(seed)
    sp = []
    for cin, cout, k in zip(SF.STEM_IN, SF.STEM_FILTERS, SF.STEM_KSIZE):
        w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(2 / (cin * k * k))
        sp.append((torch.tensor(w, dtype=torch.bfloat16),
                   torch.tensor(rng.standard_normal(cout) * 0.1,
                                dtype=torch.float32)))
    return sp


def _unpack(packed, depth, n):
    """[depth, n] uint16 (the bfloat16 bits) from a packed tensor, by the
    documented byte formula, and the bytes no element maps to."""
    raw = packed.contiguous().view(torch.uint8).reshape(-1).numpy()
    chunk = n * 128
    assert raw.size % chunk == 0
    k = np.arange(depth)[:, None]
    j = np.arange(n)[None, :]
    off = ((k // 64) * chunk + j * 128 + (((k % 64) // 8) ^ (j % 8)) * 16
           + (k % 8) * 2)
    got = raw[off].astype(np.uint16) | (raw[off + 1].astype(np.uint16) << 8)
    used = np.zeros(raw.size, bool)
    used[off] = used[off + 1] = True
    return got, raw[~used]


def _bits(w):
    return w.contiguous().view(torch.int16).numpy().astype(np.uint16)


def _check(packed, want):
    """packed unpacks to ``want`` ([depth, n] bfloat16) exactly, with
    zeros in every byte past the depth and whole 64-deep chunks."""
    depth, n = want.shape
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (-(-depth // 64), n, 64)
    got, rest = _unpack(packed, depth, n)
    assert np.array_equal(got, _bits(want))
    assert not rest.any()


@pytest.mark.parametrize("t,k,n", [(1, 16, 8), (3, 32, 24), (9, 64, 128),
                                   (5, 48, 40)])
def test_wg_weights_unpacks_by_the_documented_formula(t, k, n):
    """Any [T, K, N] (K a multiple of 16, N of 8): the documented index
    and swizzle give back every element, depth in tap-then-channel
    order, and the last chunk's padding is zero."""
    rng = np.random.default_rng(t * 100 + k + n)
    w = torch.tensor(rng.standard_normal((t, k, n)), dtype=torch.bfloat16)
    _check(SF.wg_weights(w), w.reshape(t * k, n))


def test_k1_conv0_packs_its_paired_taps():
    """conv0 [3, 3, 3, 32]: six 16-deep steps, step 2 ky + pair holding
    taps kx = 2 pair (k 0..7) and 2 pair + 1 (k 8..15) of row ky, input
    channels 3..7 and the fourth column zero: depth 96, two chunks."""
    w = _stem_params()[0][0]
    want = torch.zeros(96, 32, dtype=torch.bfloat16)
    for ky in range(3):
        for kx in range(3):
            step, half = 2 * ky + kx // 2, kx % 2
            row = 16 * step + 8 * half
            want[row:row + 3] = w[ky, kx]
    _check(SF.wg_weights_conv0(w), want)


@pytest.mark.parametrize("conv", [1, 2, 3, 4])
def test_k1_convs_pack_exactly(conv):
    """K1's convs 1, 2, 3 and 5 at full width: depth (ky, kx, cin) in
    ``RowsConv``'s tap order, width cout."""
    w = _stem_params()[conv][0]
    kh, kw, cin, cout = w.shape
    _check(SF.wg_weights_conv(w), w.reshape(kh * kw * cin, cout))


@pytest.mark.parametrize("conv", [0, 2, 3])
def test_k2_stride1_adjoints_pack_exactly(conv):
    """K2's conv0ᵀ (cin padded 3 -> 8), conv2ᵀ and conv3ᵀ: depth (dy, dx,
    the forward's cout) in ``RowsT1``'s tap order, width the forward's cin,
    each element the forward HWIO weight with its channel axes swapped."""
    w = _stem_params()[conv][0]
    kh, kw, cin, cout = w.shape
    v = SF.stem_bwd_params(_stem_params())[conv]
    want = torch.zeros(kh * kw * cout, v.shape[-1], dtype=torch.bfloat16)
    for dy in range(kh):
        for dx in range(kw):
            tap = dy * kw + dx
            want[tap * cout:(tap + 1) * cout, :cin] = w[dy, dx].T
    _check(SF.wg_weights_conv(v), want)


def test_t2_parity_taps_cover_each_tap_once():
    """The four output parities' taps (``RowsT2``: an even output row
    takes dy = 1, an odd one dy = 0 then 2; columns alike) use each of the
    nine taps once: 1, 2, 2 and 4 of them."""
    taps = SF.T2_PARITY_TAPS
    assert [len(t) for t in taps] == [1, 2, 2, 4]
    assert taps[0] == ((1, 1),)
    assert taps[1] == ((1, 0), (1, 2)) and taps[2] == ((0, 1), (2, 1))
    assert taps[3] == ((0, 0), (0, 2), (2, 0), (2, 2))
    assert sorted(t for p in taps for t in p) == [
        (dy, dx) for dy in range(3) for dx in range(3)]


@pytest.mark.parametrize("conv", [1, 4])
def test_k2_stride2_adjoints_pack_per_parity(conv):
    """K2's conv1ᵀ (64 -> 32) and conv5ᵀ (128 -> 64): one GEMM per output
    parity, its taps in ``RowsT2``'s order, depth (tap, the forward's
    cout), the four parities' chunks back to back (whole chunks: cout is
    a multiple of 64)."""
    sp = _stem_params()
    w = sp[conv][0]
    _, _, cin, cout = w.shape
    v = SF.stem_bwd_params(sp)[conv]
    packed = SF.wg_weights_t2(v)
    per_tap = cout // 64  # chunks a tap
    start = 0
    for taps in SF.T2_PARITY_TAPS:
        nch = len(taps) * per_tap
        want = torch.cat([w[dy, dx].T for dy, dx in taps])
        _check(packed[start:start + nch].contiguous(), want)
        start += nch
    assert start == packed.shape[0] == 9 * per_tap


def test_packed_copies_built_once_per_weight_tensor():
    """``_mma_cached`` keeps one packed copy per weight tensor and build
    function: the ``wgmma`` packings and the ``mma.sync`` fragment order
    (``mma_weights``, K8a's and K6's) of one tensor live side by side, and
    an in-place change of the tensor rebuilds them."""
    sp = _stem_params()
    sbp = SF.stem_bwd_params(sp)
    w1, v5 = sp[1][0], sbp[4]
    p1 = PC._mma_cached(w1, SF.wg_weights_conv)
    t5 = PC._mma_cached(v5, SF.wg_weights_t2)
    f5 = PC._mma_cached(v5)
    assert PC._mma_cached(w1, SF.wg_weights_conv) is p1
    assert PC._mma_cached(v5, SF.wg_weights_t2) is t5
    assert PC._mma_cached(v5) is f5 and f5 is not t5
    assert torch.equal(t5, SF.wg_weights_t2(v5))
    c0 = PC._mma_cached(sp[0][0], SF.wg_weights_conv0)
    assert PC._mma_cached(sp[0][0], SF.wg_weights_conv0) is c0
    w1.mul_(2)
    p1b = PC._mma_cached(w1, SF.wg_weights_conv)
    assert p1b is not p1 and torch.equal(p1b, SF.wg_weights_conv(w1))
    # another tensor of the same values has its own copy
    w1c = w1.clone()
    assert PC._mma_cached(w1c, SF.wg_weights_conv) is not p1b
