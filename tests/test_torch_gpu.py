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
    y = torch.randn(2, 16, 16, 128, generator=g).to(cuda, dtype)
    yp = PC.to_planar_plain(y)
    n = (PC.to_planar.launches, PC.to_planar.tiled_launches)
    assert torch.equal(PC.to_planar(y), yp)
    assert (PC.to_planar.launches, PC.to_planar.tiled_launches) == (
        n[0], n[1] + 1)
    assert torch.equal(PC.from_planar(yp, 16, 128), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", [(2, 32), (1, 96)])
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


def test_detector_takes_fused_route_on_cuda(cuda):
    net = PM.build_network(PM.yolov3_blocks(width=64, height=64))
    params = PM.init_params(net, 0)
    det = PE.Detector(net, params, img_size=64, device=cuda)
    n = (PC.to_planar.launches, SF.fused_stem_fwd.launches,
         PC.from_planar.launches)
    images = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    dets, valid, sat = det.detect_batch_device(images, 0.4, 0.4)
    assert PM.last_routes()["stem"] == "fused"
    assert (PC.to_planar.launches, SF.fused_stem_fwd.launches,
            PC.from_planar.launches) == (n[0] + 2, n[1] + 1, n[2] + 1)
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
@pytest.mark.parametrize("b,h", [(2, 32), (1, 96)])
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
@pytest.mark.parametrize("b,h", [(2, 32), (1, 96)])
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


def test_to_planar_g5_geometry_exact(cuda):
    """K3a at the cotangent's width (C = 128, the tiled transpose) and on
    a wide input with a column decimation and channel padding; both K3a
    variants agree with the plain version bit for bit."""
    g = torch.Generator().manual_seed(4)
    g5 = torch.randn(2, 24, 24, 128, generator=g).to(cuda, torch.bfloat16)
    want = PC.to_planar_plain(g5)
    n = PC.to_planar.tiled_launches
    assert torch.equal(PC.to_planar(g5), want)
    assert PC.to_planar.tiled_launches == n + 1
    for tiled in (False, True):
        assert torch.equal(PC._to_planar_launch(g5, None, 1, 0, tiled), want)
    x = torch.randn(3, 5, 70, 40, generator=g).to(cuda)
    for off in (0, 1):
        want = PC.to_planar_plain(x, 48, 2, off)
        for tiled in (False, True):
            assert torch.equal(PC._to_planar_launch(x, 48, 2, off, tiled),
                               want)
    # more rows than the grid's z limit (65535): the tiled kernel's blocks
    # loop over rows
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
    # (k, stride, cin, cout, res, gate, slope)
    (3, 1, 8, 32, False, False, 0.1), (3, 2, 32, 64, False, False, 0.1),
    (1, 1, 64, 32, False, False, 0.1), (3, 1, 64, 128, False, True, None),
    (1, 1, 32, 64, True, True, None), (1, 1, 64, 128, True, False, None),
    (3, 1, 32, 8, False, False, None), (3, 1, 20, 12, True, True, 0.1),
    (3, 2, 16, 24, True, True, 0.1), (1, 1, 40, 16, False, True, 0.1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,s,cin,cout,res,gate,slope", K4_VARIANTS)
def test_planar_conv_kernel_matches_plain(cuda, dtype, k, s, cin, cout, res,
                                          gate, slope):
    """K4 in every geometry (1x1, 3x3 s1, 3x3 s2), with and without res,
    gate and leaky, channel blocks of 32, 16 and 8 and a cout that is no
    multiple of 8, against ``planar_conv_plain``; the border and padding
    lanes are zero though the output block was dirty."""
    g = torch.Generator().manual_seed(11)
    b, h, w_img = 2, 40, 72  # tiles past the image on both axes
    x = torch.randn(b, h, w_img, cin, generator=g).to(cuda, dtype)
    xp = PC.to_planar(x)
    wt = (torch.randn(k, k, cin, cout, generator=g) * 0.2).to(cuda, dtype)
    bias = (torch.randn(cout, generator=g) * 0.1).to(cuda)
    ho, wo = h // s, w_img // s
    wl = (wo + 2 + 127) // 128 * 128
    rp = gp = None
    if res:
        rp = PC.to_planar(torch.randn(b, ho, wo, cout, generator=g).to(
            cuda, dtype))
    if gate:
        gp = PC.to_planar(torch.randn(b, ho, wo, cout, generator=g).to(
            cuda, dtype))
    torch.full((b, ho, cout, wl), float("nan"), dtype=dtype, device=cuda)
    name = ("launches_k1" if k == 1 else "launches_k3" if s == 1
            else "launches_k3s2")
    n = getattr(PC.planar_conv, name)
    got = PC.planar_conv(xp, wt, bias, rp, k=k, stride=s, slope=slope,
                         w_img=w_img, gate=gp)
    torch.cuda.synchronize()
    assert getattr(PC.planar_conv, name) == n + 1
    want = PC.planar_conv_plain(xp, wt, bias, rp, k=k, stride=s, slope=slope,
                                w_img=w_img, gate=gp)
    assert got.shape == want.shape == (b, ho, cout, wl)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h", [(2, 16), (1, 40)])
def test_res152_kernels_match_plain(cuda, dtype, b, h):
    """K6a with and without its masks and K6b against their plain
    versions; the masks agree but for sign flips of values within a
    rounding of 0 (at most 1e-5 of them, or 2), every border and padding
    lane of every output is zero though the blocks were dirty."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import res_fused as RF
    fwd, bwd = _stage_weights(dtype, cuda)
    g = torch.Generator().manual_seed(13)
    xp = PC.to_planar(torch.randn(b, h, h, 128, generator=g).to(cuda, dtype))
    wl = xp.shape[-1]
    torch.full(xp.shape, float("nan"), dtype=dtype, device=cuda)
    for c in (64, 128, 64, 128):
        torch.full((b, h, c, wl), 7, dtype=torch.int8, device=cuda)
    n = (RF.res152_fused.launches, RF.res152_fused.save_launches,
         RF.res152_fused_grad.launches)
    y11 = RF.res152_fused(xp, fwd)
    y11s, *masks = RF.res152_fused(xp, fwd, save=True)
    torch.cuda.synchronize()
    assert torch.equal(y11, y11s)
    want, *wmasks = RF.res152_fused_plain(xp, fwd, save=True)
    _close(y11, want, dtype, "res152_fused")
    for t in (y11, *masks):
        assert not t[..., 0].any() and not t[..., h + 1:].any()
    flips = sum(int((m != w).sum().item()) for m, w in zip(masks, wmasks))
    assert flips <= max(2, 1e-5 * sum(m.numel() for m in masks)), flips
    g11 = PC.to_planar(torch.randn(b, h, h, 128, generator=g).to(cuda, dtype))
    torch.full(xp.shape, float("nan"), dtype=dtype, device=cuda)
    g5 = RF.res152_fused_grad(g11, masks, bwd)
    torch.cuda.synchronize()
    _close(g5, RF.res152_fused_grad_plain(g11, masks, bwd), dtype,
           "res152_fused_grad")
    assert not g5[..., 0].any() and not g5[..., h + 1:].any()
    assert (RF.res152_fused.launches, RF.res152_fused.save_launches,
            RF.res152_fused_grad.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)


@pytest.mark.parametrize("stem,res152", [("fused", "fused"),
                                         ("planar", "planar"),
                                         ("planar", "fused")])
def test_kernel_routes_grad_match_conv_walk_on_card(cuda, stem, res152):
    """float32, TF32 off: heads and the input gradient through each kernel
    route equal the conv walk's (summation order only)."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
    net = PM.build_network(PM.yolov3_blocks(width=64, height=64))
    model = PM.Darknet(net, PM.init_params(net, 0), torch.float32,
                       device=cuda)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(5)
                   ).to(cuda)
    out = []
    for kw in ({"fused_stem": stem == "fused", "planar_stem": stem ==
                "planar", "res152": res152}, {}):
        xr = x.clone().requires_grad_(True)
        with _cuda.no_tf32():
            heads = model(xr, **kw)
            routes = tuple(PM.last_routes().values())
            sum(h.square().mean() for h in heads).backward()
        out.append(([h.detach() for h in heads], xr.grad, routes))
    assert out[0][2] == (stem, res152) and out[1][2] == ("conv", "conv")
    for hk, hw in zip(out[0][0], out[1][0]):
        assert (hk - hw).abs().max().item() <= 1e-4 * hw.abs().max().item()
    rel = ((out[0][1] - out[1][1]).norm() / out[1][1].norm()).item()
    assert rel <= 1e-4, rel


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
