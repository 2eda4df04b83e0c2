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
    assert torch.equal(PC.to_planar(y), yp)
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
