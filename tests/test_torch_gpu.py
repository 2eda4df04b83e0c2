"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card, which
skips with a reason where there is none (decided at run time, never at
import, so every pytest worker collects the same tests). On the card:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest

Tolerances: the layout kernels move bits and must be exact; the fused
stem in float32 agrees with its plain version to float32 summation order
(2e-5 of the output scale), in bfloat16 to two bf16 ulps of the output
scale (summation order may flip an intermediate's rounding), with a mean
error far below that.
"""

import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import evals as PE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF


pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _stem_params(dtype, device, seed=7):
    rng = np.random.default_rng(seed)
    sp = []
    for cin, cout, k in zip(SF.STEM_IN, SF.STEM_FILTERS, SF.STEM_KSIZE):
        w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(2 / (cin * k * k))
        b = rng.standard_normal(cout) * 0.1
        sp.append((torch.tensor(w, dtype=dtype, device=device),
                   torch.tensor(b, dtype=torch.float32, device=device)))
    return sp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_kernels_exact(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 64, 64, 3, generator=g).to(cuda, dtype)
    n = PC.to_planar.launches
    for off in (0, 1):
        assert torch.equal(PC.to_planar(x, 8, 2, off),
                           PC.to_planar_plain(x, 8, 2, off))
    assert PC.to_planar.launches == n + 2
    # split_phases: both phases from one launch of the narrow form
    n = (PC.to_planar.launches, PC.to_planar.phases_launches)
    xe, xo = SF.split_phases(x)
    assert (PC.to_planar.launches, PC.to_planar.phases_launches) == (
        n[0], n[1] + 1)
    assert torch.equal(xe, PC.to_planar_plain(x, 8, 2, 0))
    assert torch.equal(xo, PC.to_planar_plain(x, 8, 2, 1))
    y = torch.randn(2, 16, 16, 128, generator=g).to(cuda, dtype)
    yp = PC.to_planar_plain(y)
    n = (PC.to_planar.launches, PC.to_planar.tiled_launches)
    assert torch.equal(PC.to_planar(y), yp)
    assert (PC.to_planar.launches, PC.to_planar.tiled_launches) == (
        n[0], n[1] + 1)
    assert torch.equal(PC.from_planar(yp, 16, 128), y)


DTYPES = [torch.float32, torch.bfloat16]


def _nan_like(t):
    """A block of ``t``'s shape filled with NaN, for a kernel to write
    into: a lane or channel it fails to write shows."""
    return torch.full_like(t, float("nan"))


def _nhwc(shape, dtype, device, seed, storage_offset=0):
    """A contiguous NHWC tensor from a seed, as a view ``storage_offset``
    elements into its storage (off 16-byte alignment for 1)."""
    g = torch.Generator().manual_seed(seed)
    n = int(np.prod(shape))
    flat = torch.randn(storage_offset + n, generator=g).to(device, dtype)
    x = flat[storage_offset:].view(shape)
    assert x.is_contiguous() and x.storage_offset() == storage_offset
    return x


# (C, c_pad, W): odd and even W, row pitches W * C * esz that are no
# multiple of 16 bytes (W = 20, C = 3: 120 bytes in bfloat16)
NARROW_CASES = [(1, 8, 20), (3, 8, 20), (3, 8, 21), (5, None, 13),
                (8, 16, 21), (31, 32, 9), (31, 40, 76)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,c_pad,w", NARROW_CASES)
@pytest.mark.parametrize("step,offset", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("storage_offset", [0, 1])
def test_to_planar_narrow_exact(cuda, dtype, c, c_pad, w, step, offset,
                                storage_offset):
    """K3a's narrow form (C < 32) equals ``to_planar_plain`` bit for bit,
    every padding lane and channel written."""
    x = _nhwc((3, 5, w, c), dtype, cuda, c * w + step + offset,
              storage_offset)
    want = PC.to_planar_plain(x, c_pad, step, offset)
    out = _nan_like(want)
    n = (PC.to_planar.launches, PC.to_planar.tiled_launches)
    got = PC._to_planar_into(x, out, c_pad, step, offset)
    assert got is out
    assert (PC.to_planar.launches, PC.to_planar.tiled_launches) == (
        n[0] + 1, n[1])
    assert torch.equal(got, want)


# (C, W): W = 253 gives the two phases different lane widths (127 and 126
# columns: Wl 256 and 128); odd W leaves the odd phase one zero lane more
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,w", [(3, 608), (3, 21), (1, 20), (5, 7),
                                 (8, 253), (3, 1)])
@pytest.mark.parametrize("storage_offset", [0, 1])
def test_split_phases_one_launch_exact(cuda, dtype, c, w, storage_offset):
    x = _nhwc((2, 4, w, c), dtype, cuda, 40 + w, storage_offset)
    want = [PC.to_planar_plain(x, 8, 2, o) for o in (0, 1)]
    outs = [_nan_like(t) for t in want]
    n = (PC.to_planar.launches, PC.to_planar.phases_launches)
    xe, xo = PC._to_planar_phases_into(x, *outs, 8)
    assert xe is outs[0] and xo is outs[1]
    assert (PC.to_planar.launches, PC.to_planar.phases_launches) == (
        n[0], n[1] + 1)
    assert torch.equal(xe, want[0]) and torch.equal(xo, want[1])
    # split_phases is that one launch
    n = (PC.to_planar.launches, PC.to_planar.phases_launches)
    xe, xo = SF.split_phases(x)
    assert (PC.to_planar.launches, PC.to_planar.phases_launches) == (
        n[0], n[1] + 1)
    assert torch.equal(xe, want[0]) and torch.equal(xo, want[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [32, 48, 128, 256])
@pytest.mark.parametrize("w", [16, 76, 152])
@pytest.mark.parametrize("extra", [0, 8])
def test_to_planar_tiled_exact(cuda, dtype, c, w, extra):
    """K3a's tiled form (C >= 32), with and without padding channels."""
    x = _nhwc((2, 3, w, c), dtype, cuda, c + w)
    want = PC.to_planar_plain(x, c + extra)
    out = _nan_like(want)
    n = (PC.to_planar.launches, PC.to_planar.tiled_launches)
    got = PC._to_planar_into(x, out, c + extra)
    assert got is out
    assert (PC.to_planar.launches, PC.to_planar.tiled_launches) == (
        n[0], n[1] + 1)
    assert torch.equal(got, want)


# (c, cp, w_img): c < cp, w_img < wl - 1; c < 32 takes the narrow form
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,cp,w", [(3, 8, 608), (3, 8, 21), (5, 5, 13),
                                    (31, 32, 76), (32, 40, 16),
                                    (33, 40, 17), (128, 128, 152),
                                    (128, 256, 76), (256, 256, 16)])
@pytest.mark.parametrize("storage_offset", [0, 1])
def test_from_planar_exact(cuda, dtype, c, cp, w, storage_offset):
    """K3b (both forms) equals ``from_planar_plain`` bit for bit, also on
    a planar input whose base is off 16-byte alignment."""
    wl = PC._round_up(w + 2, 128)
    xp = _nhwc((2, 3, cp, wl), dtype, cuda, c + w, storage_offset)
    want = PC.from_planar_plain(xp, w, c)
    out = _nan_like(want)
    n = (PC.from_planar.launches, PC.from_planar.narrow_launches)
    got = PC._from_planar_into(xp, out, w, c)
    assert got is out
    narrow = c < 32
    assert (PC.from_planar.launches, PC.from_planar.narrow_launches) == (
        n[0] + (not narrow), n[1] + narrow)
    assert torch.equal(got, want)


def test_from_planar_above_the_old_row_cap(cuda):
    """B * H = 65,537 rows (the old grid's z limit was 65,535, and the
    wrapper raised above it): both K3b forms take them."""
    for c, cp in ((32, 32), (3, 8)):
        xp = _nhwc((1, 65537, cp, 128), torch.bfloat16, cuda, c)
        assert torch.equal(PC.from_planar(xp, 5, c),
                           PC.from_planar_plain(xp, 5, c))


# (batch, side): 32 and 96 fill whole tiles of K1 (8 y5 positions in
# bfloat16) and K2 (16 gx); 16, 48 and 80 leave a ragged last tile of K1
# and, in bfloat16, a last wgmma row block partly past the tile
STEM_SHAPES = [(2, 32), (1, 96), (3, 16), (3, 48), (3, 80)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", STEM_SHAPES)
def test_fused_stem_kernel_matches_plain(cuda, dtype, b, h):
    sp = _stem_params(dtype, cuda)
    x = torch.rand(b, h, h, 3, generator=torch.Generator().manual_seed(1)
                   ).to(cuda, dtype)
    xe, xo = SF.split_phases(x)
    # dirty the block the output will reuse: the kernel writes every lane
    torch.full((b, h // 4, 128, 128), float("nan"), dtype=dtype, device=cuda)
    n = SF.fused_stem_fwd.launches
    got = SF.fused_stem_fwd(xe, xo, sp)
    torch.cuda.synchronize()
    assert SF.fused_stem_fwd.launches == n + 1
    want = SF.fused_stem_fwd_plain(xe, xo, sp)
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-5 * scale
    else:
        assert err.max().item() <= scale * 2.0 ** -6
        assert err.mean().item() <= 1e-4 * scale
    assert not got[..., 0].any() and not got[..., h // 4 + 1:].any()


def _bitcheck_operands(k, kind, seed):
    """A [64, K] and B [K, 64] in bfloat16 from numpy: "stem" draws A as
    leaky activations of the stem's scale and B from the stem's conv5
    weights (HWIO rows in tap order, its first 64 output channels);
    "wide" spreads both over 2^-12 .. 2^12 with signs mixed, so that the
    float32 sums cancel and round often."""
    rng = np.random.default_rng(seed)
    if kind == "stem":
        a = rng.standard_normal((64, k))
        a = np.where(a > 0, a, 0.1 * a)
        w = _stem_params(torch.float32, "cpu", seed)[4][0].numpy()
        b = np.tile(w.reshape(576, 128)[:, :64], (k // 576 + 1, 1))[:k]
    else:
        a = rng.standard_normal((64, k)) * 2.0 ** rng.integers(-12, 13,
                                                                (64, k))
        b = rng.standard_normal((k, 64)) * 2.0 ** rng.integers(-12, 13,
                                                                (k, 64))
    return a, b


@pytest.mark.parametrize("k", [64, 576, 768])
@pytest.mark.parametrize("kind", ["stem", "wide"])
def test_wgmma_k16_step_matches_mma_sync_bits(cuda, k, kind):
    """wgmma.m64nNk16 and mma.sync.m16n8k16, one 16-deep step after
    another into one float32 accumulator from zero: the wgmma kernels equal
    the mma.sync ones they replaced bit for bit only if both instructions
    round each step alike. Every bit of the two products must agree."""
    a, b = _bitcheck_operands(k, kind, 11)
    a = torch.tensor(a, dtype=torch.bfloat16, device=cuda)
    b = torch.tensor(b, dtype=torch.bfloat16, device=cuda)
    d_mma, d_wg = SF.wgmma_bitcheck(a, b)
    assert torch.equal(d_mma.view(torch.int32), d_wg.view(torch.int32))
    want = a.double() @ b.double()
    assert (d_wg.double() - want).abs().max().item() <= \
        1e-4 * (a.double().abs() @ b.double().abs()).max().item()


def test_detector_takes_fused_route_on_cuda(cuda):
    net = PM.build_network(PM.yolov3_blocks(width=64, height=64))
    params = PM.init_params(net, 0)
    det = PE.Detector(net, params, img_size=64, device=cuda)
    def counts():
        return (PC.to_planar.phases_launches, PC.to_planar.launches,
                SF.fused_stem_fwd.launches, PC.from_planar.launches)
    n = counts()
    images = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    dets, valid, sat = det.detect_batch_device(images, 0.4, 0.4)
    assert PM.last_routes()["stem"] == "fused"
    # split_phases: one K3a launch for both column phases
    assert counts() == (n[0] + 1, n[1], n[2] + 1, n[3] + 1)
    assert tuple(dets.shape) == (2, 300, 7) and dets.device.type == "cuda"


def test_serve_cli_builds_a_cuda_detector(cuda):
    import argparse
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.cli import common
    ap = argparse.ArgumentParser()
    common.add_model_args(ap)
    det = common.build_detector(ap.parse_args(["--img-size", "64"]))
    assert det.device.type == "cuda" and det.fused_stem
    assert det.compute_dtype == torch.bfloat16
    rows = det.detect_batch(np.zeros((1, 64, 64, 3), np.float32), 0.4, 0.4)
    assert rows[0].shape[1] == 7


def _masks_equal_on_image(got, want, frac=1e-5):
    """Masks agree except for a few sign flips at |pre-activation| ~ 0
    (summation order), and every border and padding lane is zero."""
    n = int((got != want).sum().item())
    assert n <= max(2, frac * got.numel()), n
    return n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", STEM_SHAPES)
def test_fused_stem_save_acts_masks_match_plain(cuda, dtype, b, h):
    sp = _stem_params(dtype, cuda)
    x = torch.rand(b, h, h, 3, generator=torch.Generator().manual_seed(2)
                   ).to(cuda, dtype)
    xe, xo = SF.split_phases(x)
    for shape in ((b, h, 32, 128), (b, h // 2, 64, 128)):
        torch.full(shape, 7, dtype=torch.int8, device=cuda)
    n = (SF.fused_stem_fwd.launches, SF.fused_stem_fwd.save_acts_launches)
    got = SF.fused_stem_fwd(xe, xo, sp, save_acts=True)
    torch.cuda.synchronize()
    assert (SF.fused_stem_fwd.launches,
            SF.fused_stem_fwd.save_acts_launches) == (n[0], n[1] + 1)
    want = SF.fused_stem_fwd_plain(xe, xo, sp, save_acts=True)
    # y5 as the forward alone
    assert torch.equal(got[0], SF.fused_stem_fwd(xe, xo, sp))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int8 and g.shape == w.shape
        _masks_equal_on_image(g, w)
        assert not g[..., 0].any() and not g[..., h // 2 + 1:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", STEM_SHAPES)
def test_fused_stem_bwd_kernel_matches_plain(cuda, dtype, b, h):
    sp = _stem_params(dtype, cuda)
    sbp = SF.stem_bwd_params(sp)
    g = torch.Generator().manual_seed(3)
    x = torch.rand(b, h, h, 3, generator=g).to(cuda, dtype)
    xe, xo = SF.split_phases(x)
    acts = SF.fused_stem_fwd(xe, xo, sp, save_acts=True)
    g5 = torch.randn(b, h // 4, h // 4, 128, generator=g).to(cuda, dtype)
    g5p = PC.to_planar(g5)
    n = SF.fused_stem_bwd_saved.launches
    got = SF.fused_stem_bwd_saved(acts, g5p, sbp)
    torch.cuda.synchronize()
    assert SF.fused_stem_bwd_saved.launches == n + 1
    want = SF.fused_stem_bwd_saved_plain(acts, g5p, sbp)
    for gk, wk in zip(got, want):
        scale = wk.float().abs().max().item()
        err = (gk.float() - wk.float()).abs().max().item()
        if dtype == torch.float32:
            assert err <= 2e-5 * scale, (err, scale)
        else:
            assert err <= scale * 2.0 ** -6, (err, scale)
        assert not gk[..., 0].any() and not gk[..., h // 2 + 1:].any()
        assert not gk[:, :, 3:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", [(2, 32), (1, 96)])
def test_fused_stem_remat_kernel_matches_plain_and_k2(cuda, dtype, b, h):
    """K5 against K2 on K1's save_acts masks of the same x. In either dtype
    K5 recomputes the masks with K1's own arithmetic (float32: the CUDA-core
    conv_stage; bfloat16: K1's wgmma GEMMs on K1's packed weights, the same
    sums in the same order) and runs K2's chain on them, so it equals K2
    bit for bit; with
    the plain chain on those masks it agrees at K2's tolerances. Against
    its own plain version, whose recompute sums in cuDNN's order, K5
    differs only where that order flips a gate: K2's tolerances where no
    mask flipped. Every border, padding lane and padding channel is zero
    though the output blocks were dirty."""
    sp = _stem_params(dtype, cuda)
    sbp = SF.stem_bwd_params(sp)
    g = torch.Generator().manual_seed(6)
    x = torch.rand(b, h, h, 3, generator=g).to(cuda, dtype)
    xe, xo = SF.split_phases(x)
    acts = SF.fused_stem_fwd(xe, xo, sp, save_acts=True)
    g5p = PC.to_planar(torch.randn(b, h // 4, h // 4, 128, generator=g).to(
        cuda, dtype))
    k2 = SF.fused_stem_bwd_saved(acts, g5p, sbp)
    torch.full(xe.shape, float("nan"), dtype=dtype, device=cuda)
    n = SF.fused_stem_bwd.launches
    got = SF.fused_stem_bwd(xe, xo, acts[0], g5p, sp, sbp)
    torch.cuda.synchronize()
    assert SF.fused_stem_bwd.launches == n + 1
    chain = SF.fused_stem_bwd_saved_plain(acts, g5p, sbp)
    own = SF.fused_stem_bwd_plain(xe, xo, acts[0], g5p, sp, sbp)
    plain_masks = SF.fused_stem_fwd_plain(xe, xo, sp, save_acts=True)[1:]
    flips = sum(_masks_equal_on_image(m, w)
                for m, w in zip(acts[1:], plain_masks))
    for gk, k2k, ck, ok in zip(got, k2, chain, own):
        assert torch.equal(gk, k2k)
        _close(gk, ck, dtype, "fused_stem_bwd on K1's masks")
        if flips == 0:
            _close(gk, ok, dtype, "fused_stem_bwd")
        assert not gk[..., 0].any() and not gk[..., h // 2 + 1:].any()
        assert not gk[:, :, 3:].any()


def test_to_planar_g5_geometry_exact(cuda):
    """K3a at the cotangent's width (C = 128, the tiled transpose), on a
    wide input with a column decimation and channel padding, at a C that
    is no multiple of the vector (scalar loads) and on an input off
    16-byte alignment: equal to the plain version bit for bit."""
    g = torch.Generator().manual_seed(4)
    g5 = torch.randn(2, 24, 24, 128, generator=g).to(cuda, torch.bfloat16)
    want = PC.to_planar_plain(g5)
    n = PC.to_planar.tiled_launches
    assert torch.equal(PC.to_planar(g5), want)
    assert PC.to_planar.tiled_launches == n + 1
    x = torch.randn(3, 5, 70, 40, generator=g).to(cuda)
    for off in (0, 1):
        assert torch.equal(PC.to_planar(x, 48, 2, off),
                           PC.to_planar_plain(x, 48, 2, off))
    for dtype in DTYPES:
        x = _nhwc((2, 3, 19, 33), dtype, cuda, 5)
        assert torch.equal(PC.to_planar(x, 40, 2, 1),
                           PC.to_planar_plain(x, 40, 2, 1))
        x = _nhwc((2, 3, 19, 64), dtype, cuda, 6, storage_offset=1)
        assert torch.equal(PC.to_planar(x), PC.to_planar_plain(x))
    # more rows than the old grid's z limit (65535): the blocks walk rows
    x = torch.randn(1, 65537, 3, 32, generator=g).to(cuda, torch.bfloat16)
    assert torch.equal(PC.to_planar(x), PC.to_planar_plain(x))


def test_fused_stem_grad_matches_conv_walk_on_card(cuda):
    """float32, TF32 off: the input gradient through K1 (save_acts) + K2
    equals the conv walk's (summation order only)."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
    net = PM.build_network(PM.yolov3_blocks(width=64, height=64))
    model = PM.Darknet(net, PM.init_params(net, 0), torch.float32,
                       device=cuda)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(5)
                   ).to(cuda)
    grads = []
    for fused in (True, False):
        xr = x.clone().requires_grad_(True)
        with _cuda.no_tf32():
            heads = model(xr, fused_stem=fused)
            sum(h.square().mean() for h in heads).backward()
        assert PM.last_routes()["stem"] == ("fused" if fused else "conv")
        grads.append(xr.grad)
    rel = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
    assert rel <= 1e-4, rel


def _close(got, want, dtype, what):
    """float32: summation order (2e-5 of the scale); bfloat16: two bf16
    ulps of the scale (an intermediate's rounding may flip), mean far
    below."""
    scale = max(want.float().abs().max().item(), 1e-30)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 2e-5 * scale, (what, err.max(), scale)
    else:
        assert err.max().item() <= 2.0 ** -6 * scale, (what, err.max(),
                                                       scale)
        assert err.mean().item() <= 1e-3 * scale, (what, err.mean(), scale)


K4_VARIANTS = [
    # (k, stride, cin, cout, res, gate, slope); stride "t2": the stride-2
    # adjoint variant (planar_conv_t2), cin and cout its own
    (3, 1, 8, 32, False, False, 0.1), (3, 2, 32, 64, False, False, 0.1),
    (1, 1, 64, 32, False, False, 0.1), (3, 1, 64, 128, False, True, None),
    (1, 1, 32, 64, True, True, None), (1, 1, 64, 128, True, False, None),
    (3, 1, 32, 8, False, False, None), (3, 1, 20, 12, True, True, 0.1),
    (3, 2, 16, 24, True, True, 0.1), (1, 1, 40, 16, False, True, 0.1),
    (3, 1, 136, 40, False, False, 0.1), (3, 2, 72, 128, True, False, 0.1),
    # the slim victim's stem forward (8/16/8/16/32), its Detector's path
    (3, 1, 8, 8, False, False, 0.1), (3, 2, 8, 16, False, False, 0.1),
    (1, 1, 16, 8, False, False, 0.1), (3, 1, 8, 16, False, False, 0.1),
    (3, 2, 16, 32, False, False, 0.1),
    (3, "t2", 128, 64, False, False, None),
    (3, "t2", 64, 32, False, True, None),
    (3, "t2", 24, 12, False, True, None),
    (3, "t2", 40, 12, False, False, None),
    # every channel width of the wgmma kernel (8 to 128, the adjoint's
    # channel blocks of 32), two 64-channel chunks
    (3, 2, 32, 8, False, True, 0.1), (3, 2, 64, 16, True, False, 0.1),
    (1, 1, 128, 128, True, True, None), (3, 1, 128, 64, False, True, None),
    (3, "t2", 32, 8, False, True, None), (3, "t2", 64, 16, False, False,
                                          None),
    (3, "t2", 64, 128, False, True, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,s,cin,cout,res,gate,slope", K4_VARIANTS)
def test_planar_conv_kernel_matches_plain(cuda, dtype, k, s, cin, cout, res,
                                          gate, slope):
    """K4 in every geometry (1x1, 3x3 s1, 3x3 s2, the stride-2 adjoint on
    the unexpanded cotangent), with and without res, gate and leaky, every
    channel block (8 to 64), cin past one shared-memory chunk and couts
    that are no multiple of 8, against ``planar_conv_plain`` (the adjoint:
    ``planar_conv_t2_plain``, the zero interleave then the stride-1 conv):
    float32 to summation order, bfloat16 within two bf16 ulps of the
    output scale with a mean below 1e-4 of it; the border and padding
    lanes are zero though the output block was dirty."""
    g = torch.Generator().manual_seed(11)
    b, h, w_img = 2, 40, 72  # tiles past the image on both axes
    t2 = s == "t2"
    hi, wi = (h // 2, w_img // 2) if t2 else (h, w_img)
    x = torch.randn(b, hi, wi, cin, generator=g).to(cuda, dtype)
    xp = PC.to_planar(x)
    wt = (torch.randn(k, k, cin, cout, generator=g) * 0.2).to(cuda, dtype)
    bias = (torch.randn(cout, generator=g) * 0.1).to(cuda)
    ho, wo = (h, w_img) if t2 else (h // s, w_img // s)
    wl = (wo + 2 + 127) // 128 * 128
    rp = gp = None
    if res:
        rp = PC.to_planar(torch.randn(b, ho, wo, cout, generator=g).to(
            cuda, dtype))
    if gate:
        gp = PC.to_planar(torch.randn(b, ho, wo, cout, generator=g).to(
            cuda, dtype))
    torch.full((b, ho, cout, wl), float("nan"), dtype=dtype, device=cuda)
    name = ("launches_k3t2" if t2 else "launches_k1" if k == 1
            else "launches_k3" if s == 1 else "launches_k3s2")
    n = getattr(PC.planar_conv, name)
    if t2:
        got = PC.planar_conv_t2(xp, wt, bias, w_img=wi, gate=gp)
    else:
        got = PC.planar_conv(xp, wt, bias, rp, k=k, stride=s, slope=slope,
                             w_img=w_img, gate=gp)
    torch.cuda.synchronize()
    assert getattr(PC.planar_conv, name) == n + 1
    if t2:
        want = PC.planar_conv_t2_plain(xp, wt, bias, w_img=wi, gate=gp)
    else:
        want = PC.planar_conv_plain(xp, wt, bias, rp, k=k, stride=s,
                                    slope=slope, w_img=w_img, gate=gp)
    assert got.shape == want.shape == (b, ho, cout, wl)
    _close(got, want, dtype, "planar_conv")
    if dtype == torch.bfloat16:
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().mean().item() \
            <= 1e-4 * scale
    assert not got[..., 0].any() and not got[..., wo + 1:].any()


@pytest.mark.parametrize("k,s,cin,cout,w_img", [
    (3, 1, 64, 128, 152), (1, 1, 128, 64, 152), (3, 2, 32, 64, 608),
    (3, 1, 32, 64, 304), (3, "t2", 128, 64, 152), (3, "t2", 64, 32, 304)])
def test_planar_conv_kernel_ragged_width(cuda, k, s, cin, cout, w_img):
    """bfloat16 K4 at the planar routes' widths (608, 304, 152: the last
    32-lane tile only partly in the image, tiles past it), a few rows,
    against its plain version; border and padding lanes zero in a dirty
    block."""
    g = torch.Generator().manual_seed(w_img + cout)
    dtype = torch.bfloat16
    t2 = s == "t2"
    h = 6
    x = torch.randn(1, h, w_img, cin, generator=g).to(cuda, dtype)
    xp = PC.to_planar(x)
    wt = (torch.randn(k, k, cin, cout, generator=g) * 0.1).to(cuda, dtype)
    bias = (torch.randn(cout, generator=g) * 0.1).to(cuda)
    ho, wo = (2 * h, 2 * w_img) if t2 else (h // s, w_img // s)
    wl = (wo + 2 + 127) // 128 * 128
    torch.full((1, ho, cout, wl), float("nan"), dtype=dtype, device=cuda)
    if t2:
        got = PC.planar_conv_t2(xp, wt, bias, w_img=w_img)
        want = PC.planar_conv_t2_plain(xp, wt, bias, w_img=w_img)
    else:
        got = PC.planar_conv(xp, wt, bias, k=k, stride=s, w_img=w_img)
        want = PC.planar_conv_plain(xp, wt, bias, k=k, stride=s,
                                    w_img=w_img)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (1, ho, cout, wl)
    _close(got, want, dtype, "planar_conv")
    assert not got[..., 0].any() and not got[..., wo + 1:].any()


def _stage_weights(dtype, device, seed=12):
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import res_fused as RF
    g = torch.Generator().manual_seed(seed)
    sp = [((torch.randn(*shape, generator=g) * (2.0 / (shape[0] ** 2 *
                                                       shape[2])) ** 0.5)
           .to(device, dtype), (torch.randn(shape[-1], generator=g) * 0.1)
           .to(device)) for shape in RF.FWD_SHAPES]
    return RF.res_weights(sp)


def _res152_fwd_bwd(cuda, dtype, b, h, w):
    """K6a with and without its masks and K6b against their plain
    versions at an image of h x w; the masks agree but for sign flips of
    values within a rounding of 0 (at most 1e-5 of them, or 2), every
    border and padding lane of every output is zero though the blocks were
    dirty."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import res_fused as RF
    fwd, bwd = _stage_weights(dtype, cuda)
    g = torch.Generator().manual_seed(13)
    xp = PC.to_planar(torch.randn(b, h, w, 128, generator=g).to(cuda, dtype))
    wl = xp.shape[-1]
    torch.full(xp.shape, float("nan"), dtype=dtype, device=cuda)
    for c in (64, 128, 64, 128):
        torch.full((b, h, c, wl), 7, dtype=torch.int8, device=cuda)
    n = (RF.res152_fused.launches, RF.res152_fused.save_launches,
         RF.res152_fused_grad.launches)
    y11 = RF.res152_fused(xp, fwd, w_img=w)
    y11s, *masks = RF.res152_fused(xp, fwd, save=True, w_img=w)
    torch.cuda.synchronize()
    assert torch.equal(y11, y11s)
    want, *wmasks = RF.res152_fused_plain(xp, fwd, save=True, w_img=w)
    _close(y11, want, dtype, "res152_fused")
    for t in (y11, *masks):
        assert not t[..., 0].any() and not t[..., w + 1:].any()
    flips = sum(int((m != v).sum().item()) for m, v in zip(masks, wmasks))
    assert flips <= max(2, 1e-5 * sum(m.numel() for m in masks)), flips
    g11 = PC.to_planar(torch.randn(b, h, w, 128, generator=g).to(cuda, dtype))
    torch.full(xp.shape, float("nan"), dtype=dtype, device=cuda)
    g5 = RF.res152_fused_grad(g11, masks, bwd, w_img=w)
    torch.cuda.synchronize()
    _close(g5, RF.res152_fused_grad_plain(g11, masks, bwd, w_img=w), dtype,
           "res152_fused_grad")
    assert not g5[..., 0].any() and not g5[..., w + 1:].any()
    assert (RF.res152_fused.launches, RF.res152_fused.save_launches,
            RF.res152_fused_grad.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", [(2, 16), (1, 40)])
def test_res152_kernels_match_plain(cuda, dtype, b, h):
    """``_res152_fwd_bwd`` on square images: 16 is one bfloat16 tile
    column with lanes past the image, 40 a partial last tile row and
    column."""
    _res152_fwd_bwd(cuda, dtype, b, h, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_res152_kernels_match_plain_rect(cuda, dtype):
    """``_res152_fwd_bwd`` at 24 x 36: a width neither of 8 nor of 16
    columns (the float32 and bfloat16 tiles), H != W."""
    _res152_fwd_bwd(cuda, dtype, 1, 24, 36)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_res152_kernels_match_plain_w72(cuda, dtype):
    """``_res152_fwd_bwd`` at b2, 24 x 72: the last 16-lane tile column
    (lanes 64-79) is partial, its image columns end at 71, so the wgmma
    kernels' x and g11 boxes there run past the image."""
    _res152_fwd_bwd(cuda, dtype, 2, 24, 72)


@pytest.mark.parametrize("b,h", [(2, 16), (1, 40)])
def test_res152_bf16_forward_equals_k4_route(cuda, b, h):
    """bfloat16 K6a walks each sum as K4's forward does and rounds where
    K4 and the planar stage route's two bfloat16 adds do, so its y11 and
    masks equal ``res_planar._forward``'s (K4 x 4) bit for bit."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.models import res_planar as PRP
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import res_fused as RF
    fwd, _ = _stage_weights(torch.bfloat16, cuda)
    g = torch.Generator().manual_seed(15)
    xp = PC.to_planar(torch.randn(b, h, h, 128, generator=g).to(
        cuda, torch.bfloat16))
    y11, *masks = RF.res152_fused(xp, fwd, save=True)
    want, *acts = PRP._forward(xp, fwd)
    torch.cuda.synchronize()
    assert torch.equal(y11, want)
    for m, a in zip(masks, acts):
        assert torch.equal(m, (a > 0).to(torch.int8))


def _res152_grad12(cuda, dtype, b, h, w):
    """K6c against its plain version on K6a's own masks (K6b's
    tolerances) at an image of h x w; g5's border and padding lanes are
    zero though the block was dirty."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import res_fused as RF
    fwd, bwd = _stage_weights(dtype, cuda)
    g = torch.Generator().manual_seed(14)
    w12t = RF.res12_weights((torch.randn(3, 3, 128, 256, generator=g)
                             * (2.0 / 1152) ** 0.5).to(cuda, dtype))
    xp = PC.to_planar(torch.randn(b, h, w, 128, generator=g).to(cuda, dtype))
    _, *masks = RF.res152_fused(xp, fwd, save=True, w_img=w)
    gp12 = PC.to_planar(torch.randn(b, h // 2, w // 2, 256, generator=g).to(
        cuda, dtype))
    torch.full(xp.shape, float("nan"), dtype=dtype, device=cuda)
    n = RF.res152_fused_grad12.launches
    g5 = RF.res152_fused_grad12(gp12, masks, bwd, w12t, w_img=w)
    torch.cuda.synchronize()
    assert RF.res152_fused_grad12.launches == n + 1
    _close(g5, RF.res152_fused_grad12_plain(gp12, masks, bwd, w12t, w_img=w),
           dtype, "res152_fused_grad12")
    assert not g5[..., 0].any() and not g5[..., w + 1:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", [(2, 16), (1, 40)])
def test_res152_grad12_kernel_matches_plain(cuda, dtype, b, h):
    """``_res152_grad12`` on square images."""
    _res152_grad12(cuda, dtype, b, h, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_res152_grad12_kernel_matches_plain_rect(cuda, dtype):
    """``_res152_grad12`` at 24 x 36 (conv12's 12 x 18)."""
    _res152_grad12(cuda, dtype, 1, 24, 36)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_res152_grad12_kernel_matches_plain_w72(cuda, dtype):
    """``_res152_grad12`` at b2, 24 x 72 (conv12's 12 x 36): K6c's gp12
    boxes and parity grids in a partial last tile column."""
    _res152_grad12(cuda, dtype, 2, 24, 72)


def _route_grad_vs_walk(cuda, kw):
    """float32, TF32 off: heads and the input gradient of the full-width
    YOLOv3 at 64^2 on route ``kw`` and on the conv walk. Returns (routes
    taken, largest head error over the head's scale, relative L2 of the
    gradients)."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
    net = PM.build_network(PM.yolov3_blocks(width=64, height=64))
    model = PM.Darknet(net, PM.init_params(net, 0), torch.float32,
                       device=cuda)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(5)
                   ).to(cuda)
    out = []
    for k in (kw, {}):
        xr = x.clone().requires_grad_(True)
        with _cuda.no_tf32():
            heads = model(xr, **k)
            routes = tuple(PM.last_routes().values())
            sum(h.square().mean() for h in heads).backward()
        out.append(([h.detach() for h in heads], xr.grad, routes))
    assert out[1][2] == ("conv", "conv")
    err = max(((hk - hw).abs().max() / hw.abs().max()).item()
              for hk, hw in zip(out[0][0], out[1][0]))
    rel = ((out[0][1] - out[1][1]).norm() / out[1][1].norm()).item()
    return out[0][2], err, rel


@pytest.mark.parametrize("stem,res152", [("fused", "fused"),
                                         ("planar", "planar"),
                                         ("planar", "fused")])
def test_kernel_routes_grad_match_conv_walk_on_card(cuda, stem, res152):
    """float32, TF32 off: heads and the input gradient through each kernel
    route equal the conv walk's (summation order only)."""
    routes, err, rel = _route_grad_vs_walk(
        cuda, {"fused_stem": stem == "fused", "planar_stem": stem == "planar",
               "res152": res152})
    assert routes == (stem, res152)
    assert err <= 1e-4 and rel <= 1e-4, (err, rel)


def test_detector_takes_planar_stem_for_the_slim_victim(cuda):
    """The slim victim's narrow stem takes the planar route (K4) on the
    card, and with ``res152="planar"`` its stage too."""
    import os
    cfg = os.path.join(os.path.dirname(__file__), "fixtures",
                       "refparity_slim", "yolov3_dota_slim.cfg")
    net = PM.network_from_cfg(cfg)
    params = PM.init_params(net, 0)
    images = np.random.default_rng(3).integers(0, 256, (1, 64, 64, 3),
                                               dtype=np.uint8)
    for res152, routes in ((None, ("planar", "conv")),
                           ("planar", ("planar", "planar"))):
        det = PE.Detector(net, params, img_size=64, device=cuda,
                          compute_dtype=torch.float32, res152=res152)
        n = PC.planar_conv.launches_k3
        det.detect_batch_device(images, 0.4, 0.4)
        assert tuple(PM.last_routes().values()) == routes
        assert PC.planar_conv.launches_k3 > n


@pytest.mark.parametrize("res152,stem_remat,routes", [
    (None, True, ("fused", "conv")), ("fused", True, ("fused", "fused")),
    ("c12", False, ("c12", "c12"))])
def test_remat_and_c12_routes_grad_match_conv_walk_on_card(
        cuda, res152, stem_remat, routes):
    """As ``test_kernel_routes_grad_match_conv_walk_on_card`` through the
    recomputing stem backward (K5) and the conv12-widened route (K6c),
    each of which launched."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import res_fused as RF
    n = (SF.fused_stem_bwd.launches, RF.res152_fused_grad12.launches)
    got, err, rel = _route_grad_vs_walk(
        cuda, {"fused_stem": True, "res152": res152,
               "stem_remat": stem_remat})
    assert got == routes
    assert (SF.fused_stem_bwd.launches - n[0],
            RF.res152_fused_grad12.launches - n[1]) == (
        (0, 1) if res152 == "c12" else (1, 0))
    assert err <= 1e-4 and rel <= 1e-4, (err, rel)


def _experimental(name):
    import importlib
    return importlib.import_module(
        "adversarial_patch_based_false_positive_creation_attacks_against_"
        f"aerial_imagery_object_detectors_tpu_torch.experimental.{name}")


@pytest.mark.parametrize("case", ["ties", "zeros", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", [((3, 40, 37), 7), ((2, 2, 17, 33), 3),
                                     ((1, 9, 5), 8), ((3, 224, 224), 7),
                                     ((2, 19, 41), 1), ((2, 19, 41), 4),
                                     ((3, 40, 37), 9)])
def test_median_pool_kernel_equals_plain(cuda, dtype, shape, k, case):
    """K7 against its plain version bit for bit (int32 / int16 views: the
    median is one of the inputs, so +0 and -0 must come out as the rank
    counter's): the network form (k 1, 3, 4, 7, 8) and the rank-counting
    form (k 9), ties, leading dims, tiles past the image, even k, +-0,
    +-inf and windows on both sides of the NaN count that gives -inf; once
    by the wrapper and once into a block filled with NaN."""
    MPL = _experimental("median_pallas")
    x = torch.from_numpy(MPL.check_input(shape, k, case, seed=15 + k))
    x = x.to(cuda, dtype)
    n = (MPL.median_pool_2d_pallas.launches,
         MPL.median_pool_2d_pallas.network_launches)
    got = MPL.median_pool_2d_pallas(x, k)
    nans = torch.full_like(x, float("nan"))
    into = MPL._median_pool_into(x, nans, k)
    torch.cuda.synchronize()
    assert into is nans
    assert (MPL.median_pool_2d_pallas.launches,
            MPL.median_pool_2d_pallas.network_launches) == (
        n[0] + 2, n[1] + 2 * (k <= 8))
    want = MPL.median_pool_2d_pallas_plain(x, k)
    assert got.dtype == dtype and got.shape == x.shape
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    assert torch.equal(into.view(bits), want.view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", [(2, 32), (3, 40)])
def test_batched_stem_kernels_match_plain(cuda, dtype, b, h):
    """K8a with and without save_acts and K8b (on K8a's own activations)
    against their plain versions; every border and slack lane is zero
    though the output blocks were dirty; in both dtypes K8a's even dense
    lanes equal K1's y5 and its y0 signs K1's masks (K8a runs K1's conv
    code: conv_stage in float32, K1's wgmma convs in bfloat16)."""
    SB = _experimental("stem_batched")
    sp = _stem_params(dtype, cuda)
    sbp = SF.stem_bwd_params(sp)
    g = torch.Generator().manual_seed(16)
    x = torch.rand(b, h, h, 3, generator=g).to(cuda, dtype)
    seg = SB._seg(h // 2)
    xe, xo = SB.split_phases_b(x, seg)
    for rows, c in ((h // 4, 128), (h, 32), (h // 2, 64)):
        torch.full((rows, c, b * seg), float("nan"), dtype=dtype, device=cuda)
    n = (SB.fused_stem_fwd_b.launches, SB.fused_stem_fwd_b.save_acts_launches,
         SB.fused_stem_bwd_b.launches)
    y5 = SB.fused_stem_fwd_b(xe, xo, sp, b)
    acts = SB.fused_stem_fwd_b(xe, xo, sp, b, save_acts=True)
    torch.cuda.synchronize()
    assert torch.equal(y5, acts[0])
    want = SB.fused_stem_fwd_b_plain(xe, xo, sp, b, save_acts=True)
    for got, w in zip(acts, want):
        assert got.shape == w.shape
        _close(got, w, dtype, "fused_stem_fwd_b")
        assert not got.reshape(*got.shape[:2], b, seg)[..., 0].any()
        assert not got.reshape(*got.shape[:2], b, seg)[..., h // 2 + 1:].any()
    k1 = SF.fused_stem_fwd(*SF.split_phases(x), sp, save_acts=True)
    k8y5 = SB.batched_to_nhwc(y5, b, h // 4, 128, 1, 2)
    k1y5 = PC.from_planar(k1[0], h // 4, 128)
    m0 = SF.merge_phases(k1[1], k1[2], h // 2, 32) > 0
    k8m0 = SB.merge_phases_b(acts[1], acts[2], b, h // 2, 32) > 0
    assert torch.equal(k8y5, k1y5) and torch.equal(m0, k8m0)
    g5 = torch.randn(b, h // 4, h // 4, 128, generator=g).to(cuda, dtype)
    gp5dd = SB.nhwc_to_batched(SB.interleave_zero_rows(
        SB.interleave_zero_cols(g5)), seg)
    torch.full((h, 8, b * seg), float("nan"), dtype=dtype, device=cuda)
    gx = SB.fused_stem_bwd_b(gp5dd, acts, sbp, b)
    torch.cuda.synchronize()
    for got, w in zip(gx, SB.fused_stem_bwd_b_plain(gp5dd, acts, sbp, b)):
        _close(got, w, dtype, "fused_stem_bwd_b")
        lanes = got.reshape(h, 8, b, seg)
        assert not lanes[..., 0].any() and not lanes[..., h // 2 + 1:].any()
        assert not lanes[:, 3:].any()
    assert (SB.fused_stem_fwd_b.launches,
            SB.fused_stem_fwd_b.save_acts_launches,
            SB.fused_stem_bwd_b.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)


def test_batched_stem_grad_matches_fused_stem_on_card(cuda):
    """float32, TF32 off: the batch-on-lanes route's y5 and input gradient
    equal the fused stem's (K1 save_acts + K2) to summation order."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
    SB = _experimental("stem_batched")
    sp = _stem_params(torch.float32, cuda)
    sbp = SF.stem_bwd_params(sp)
    g = torch.Generator().manual_seed(17)
    x = torch.rand(2, 64, 64, 3, generator=g).to(cuda)
    g5 = torch.randn(2, 16, 16, 128, generator=g).to(cuda)
    outs = []
    for fn in (SB.fused_stem_batched, SF.fused_stem):
        xr = x.clone().requires_grad_(True)
        with _cuda.no_tf32():
            y = fn(xr, sp, sbp)
            y.backward(g5)
        outs.append((y.detach(), xr.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    rel = ((outs[0][1] - outs[1][1]).norm() / outs[1][1].norm()).item()
    assert rel <= 1e-5, rel


def test_batched_stem_grad_equals_fused_stem_on_card_bf16(cuda):
    """bfloat16: the batch-on-lanes route runs the fused stem's
    tensor-core code (K1's wgmma convs in K8a, K2's wgmma chain in
    K8b, its gp5 read from gp5dd's data positions and its gates from the
    saved values' signs), so its y5 and its input gradient equal the fused
    stem's (K1 save_acts + K2) bit for bit."""
    SB = _experimental("stem_batched")
    bf16 = torch.bfloat16
    sp = _stem_params(bf16, cuda)
    sbp = SF.stem_bwd_params(sp)
    g = torch.Generator().manual_seed(17)
    x = torch.rand(2, 64, 64, 3, generator=g).to(cuda, bf16)
    g5 = torch.randn(2, 16, 16, 128, generator=g).to(cuda, bf16)
    n = (SB.fused_stem_fwd_b.save_acts_launches, SB.fused_stem_bwd_b.launches)
    outs = []
    for fn in (SB.fused_stem_batched, SF.fused_stem):
        xr = x.clone().requires_grad_(True)
        y = fn(xr, sp, sbp)
        y.backward(g5)
        outs.append((y.detach(), xr.grad))
    assert (SB.fused_stem_fwd_b.save_acts_launches,
            SB.fused_stem_bwd_b.launches) == (n[0] + 1, n[1] + 1)
    assert outs[1][1].abs().max().item() > 0
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_batched_stem_bwd_partial_tile_equals_k2_bf16(cuda):
    """bfloat16 K8b at H = 72 (its last 16 x 16 gx tile half past the
    image: boxes past the tensor, rows and lanes dropped) against K2 at
    H = 80 on the same chain inputs: K2's masks the signs of K8a's saved
    activations, zero past 72; its g5 K8b's gated gp5 (zero past 18) and a
    y5 of ones (gate 1). gp5's rows and columns 17 are zero too, so every
    cotangent past the 72 image is zero in K2 as well (the chain's support
    ends at gx row and column 70) and the two agree bit for bit: K2's gx
    over the 72^2 image equals K8b's, zero beyond."""
    SB = _experimental("stem_batched")
    bf16, b, h, h2 = torch.bfloat16, 2, 72, 80
    h1, h5 = h // 2, h // 4
    sp = _stem_params(bf16, cuda)
    sbp = SF.stem_bwd_params(sp)
    g = torch.Generator().manual_seed(18)
    x = torch.rand(b, h, h, 3, generator=g).to(cuda, bf16)
    seg = SB._seg(h1)
    acts = SB.fused_stem_fwd_b(*SB.split_phases_b(x, seg), sp, b,
                               save_acts=True)
    g5 = torch.randn(b, h5, h5, 128, generator=g).to(cuda, bf16)
    g5[:, h5 - 1:] = 0
    g5[:, :, h5 - 1:] = 0
    gp5dd = SB.nhwc_to_batched(SB.interleave_zero_rows(
        SB.interleave_zero_cols(g5)), seg)
    n = SB.fused_stem_bwd_b.launches
    gx8 = SB.merge_phases_b(*SB.fused_stem_bwd_b(gp5dd, acts, sbp, b), b,
                            h1, 3)
    torch.cuda.synchronize()
    assert SB.fused_stem_bwd_b.launches == n + 1
    assert gx8.abs().max().item() > 0

    def pad(t, side):
        return torch.nn.functional.pad(
            t, (0, 0, 0, side - t.shape[2], 0, side - t.shape[1]))

    m0 = pad((SB.merge_phases_b(acts[1], acts[2], b, h1, 32) > 0).to(
        torch.int8), h2)
    masks = [PC.to_planar_plain(m0, step=2, offset=0),
             PC.to_planar_plain(m0, step=2, offset=1)]
    masks += [PC.to_planar_plain(pad((SB.batched_to_nhwc(
        a, b, h1, a.shape[1]) > 0).to(torch.int8), h2 // 2))
        for a in acts[3:]]
    y5p = PC.to_planar_plain(torch.ones(b, h2 // 4, h2 // 4, 128,
                                        dtype=bf16, device=cuda))
    g5p = PC.to_planar_plain(pad(g5, h2 // 4))
    gx2 = SF.merge_phases(*SF.fused_stem_bwd_saved(
        (y5p, *masks), g5p, sbp), h2 // 2, 3)
    assert torch.equal(gx2[:, :h, :h], gx8)
    assert not gx2[:, h:].any() and not gx2[:, :, h:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_stem_route_on_card(cuda, dtype):
    """The packed route on the card (cuDNN convs) against the conv walk:
    float32 heads within 1e-4 of their scale, bfloat16 finite; the route
    is reported."""
    net = PM.build_network(PM.yolov3_blocks(width=64, height=64))
    model = PM.Darknet(net, PM.fold_bn(net, PM.init_params(net, 0)), dtype,
                       device=cuda)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(18)
                   ).to(cuda)
    with torch.no_grad():
        packed = model(x, packed_stem=True)
        assert PM.last_routes()["stem"] == "packed"
        walk = model(x)
    for hp, hw in zip(packed, walk):
        assert bool(torch.isfinite(hp).all())
        if dtype == torch.float32:
            err = (hp - hw).abs().max().item()
            assert err <= 1e-4 * hw.abs().max().item(), err


@pytest.mark.parametrize("s,p", [(608, 224), (96, 24)])
def test_transform_patch_eval_card_equals_cpu(cuda, s, p):
    """The eval placement on the card against the CPU for the same
    generator seed: equal placements (the half-edge's mask and the warps
    are the bilinear gather op for op, theta built on the host) and the
    canvas bit for bit."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import eot_eval as EE
    rng = np.random.default_rng(4)
    patch = torch.from_numpy(rng.random((p, p, 3)).astype(np.float32))
    cfg = EE.EvalEOTConfig(img_size=s)
    for i in range(6):
        n = int(rng.integers(1, 30))
        labels = np.zeros((n, 7), np.float32)
        labels[:, :2] = rng.uniform(0.05, 0.95, (n, 2))
        labels[:, 2:4] = rng.uniform(0.02, 0.3, (n, 2))
        labels[:, 4:6] = 0.5
        adv_c, at_c = EE.transform_patch_eval(
            patch, labels, np.random.default_rng(i), cfg)
        adv_g, at_g = EE.transform_patch_eval(
            patch.to(cuda), labels, np.random.default_rng(i), cfg)
        assert at_g == at_c and adv_g.device.type == "cuda"
        assert torch.equal(adv_g.cpu(), adv_c)


def test_pgd_first_gradient_card_equals_cpu(cuda):
    """PGD's first image gradient, float32: the trained slim victim on the
    card (its planar stem, K4) against the CPU (the conv walk) within 1e-4
    relative L2; and the full-width stem geometry through the fused stem's
    training kernels (K1 ``save_acts``, K2; both launched) against the
    card's conv walk. Random weights saturate the heads' sigmoids, which
    leaves the fabrication loss's gradient to a few anchors and moves it
    by 1e-2 between summation orders, so that victim's head convs are
    scaled down 1000-fold."""
    import os
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import pgd as PP
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
    slim = os.path.join(os.path.dirname(__file__), "fixtures",
                        "refparity_slim")
    snet = PM.network_from_cfg(os.path.join(slim, "yolov3_dota_slim.cfg"))
    sp, _ = PM.load_darknet_weights(
        snet, os.path.join(slim, "yolov3_dota_slim.weights"))
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(8))
    g_cpu = PP.fabrication_grad(
        PM.Darknet(snet, sp, torch.float32, device="cpu"), x)
    g_card = PP.fabrication_grad(
        PM.Darknet(snet, sp, torch.float32, device=cuda), x.to(cuda))
    assert PM.last_routes()["stem"] == "planar"
    rel = ((g_card.cpu() - g_cpu).norm() / g_cpu.norm()).item()
    assert rel <= 1e-4, rel

    net = PM.build_network(PM.yolov3_blocks(width=64, height=64))
    params = PM.fold_bn(net, PM.init_params(net, 0))
    for i in net.yolo_indices:
        params[f"conv_{i - 1}"]["w"] = params[f"conv_{i - 1}"]["w"] * 1e-3
    model = PM.Darknet(net, params, torch.float32, device=cuda)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(8)
                   ).to(cuda)
    n = (SF.fused_stem_fwd.save_acts_launches,
         SF.fused_stem_bwd_saved.launches)
    g_k = PP.fabrication_grad(model, x)
    assert PM.last_routes()["stem"] == "fused"
    assert (SF.fused_stem_fwd.save_acts_launches,
            SF.fused_stem_bwd_saved.launches) == (n[0] + 1, n[1] + 1)
    with _cuda.no_tf32():
        xr = x.clone().requires_grad_(True)
        (g_w,) = torch.autograd.grad(PP.fabrication_loss(model(xr)), xr)
    rel = ((g_k - g_w).norm() / g_w.norm()).item()
    assert rel <= 1e-4, rel
