"""The plain reference against the program at a tiny size on the CPU, in
float32: the victim's heads and input gradient, the EOT composite from
the same draws, a training step's loss and patch gradient, and the
detection rows after decode, threshold and NMS."""

import pytest
import torch

from benchmark import inputs, port
from benchmark.reference import attack as RA
from benchmark.reference import darknet as R
from benchmark.reference import detect as RD
from benchmark.weights import victim as make_victim

from .conftest import TINY_CONFIG

SIZE = 64


@pytest.fixture(scope="module")
def victim():
    blocks, weights = make_victim(TINY_CONFIG, 11, "cpu")
    model = port.mod("models.darknet").Darknet(
        port.network(TINY_CONFIG), port.params(weights), torch.float32,
        device="cpu").eval()
    return blocks, weights, model


def _images(n, seed=3):
    return inputs.smooth_tiles(n, SIZE, seed, "cpu").float() / 255.0


def test_heads_and_input_gradient(victim):
    blocks, weights, model = victim
    x = _images(3)
    xp = x.clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    got = model(xp)
    want = R.forward(blocks, weights, xr)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    cot = [torch.randn(w.shape, generator=torch.Generator().manual_seed(i))
           for i, w in enumerate(want)]
    sum((g * c).sum() for g, c in zip(got, cot)).backward()
    sum((w * c).sum() for w, c in zip(want, cot)).backward()
    torch.testing.assert_close(xp.grad, xr.grad, rtol=1e-4, atol=1e-6)


def _draws(seed, b, p):
    eot = port.mod("attack.eot")
    g1 = torch.Generator().manual_seed(seed)
    g2 = torch.Generator().manual_seed(seed)
    prog = eot.draw_eot(g1, b, p, eot.EOTConfig(img_size=SIZE))
    ref = RA.replay_draws(g2, b, p)
    for k, v in ref.items():
        assert torch.equal(getattr(prog, k), v), k
    return prog, ref


def _labels(b, seed=5):
    counts = inputs.label_counts(b, 12, 1.0, seed)
    return torch.from_numpy(inputs.labels(counts, 12, 15, seed))


def test_eot_composite_from_the_same_draws():
    eot = port.mod("attack.eot")
    b, p = 4, 16
    prog_d, ref_d = _draws(21, b, p)
    patch = torch.rand(p, p, 3, generator=torch.Generator().manual_seed(2))
    images, labels = _images(b, 9), _labels(b)
    cfg = eot.EOTConfig(img_size=SIZE, warp_dtype=None)
    got, gc = eot.apply_eot_patch(patch, images, labels, prog_d, cfg)
    want, wc = RA.composite(patch, images, labels, ref_d, SIZE)
    torch.testing.assert_close(gc, wc)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (got != images).any()


def test_step_loss_and_patch_gradient(victim):
    blocks, weights, model = victim
    T = port.mod("train")
    exp = T.get_experiment("paper_obj", batch_size=4, img_size=SIZE,
                           patch_size=16, max_labels=12,
                           compute_dtype="float32", warp_dtype="float32")
    loss_fn = T.make_loss_fn(model, exp)
    prog_d, ref_d = _draws(33, 4, 16)
    patch = torch.rand(16, 16, 3, generator=torch.Generator().manual_seed(4))
    u8 = (_images(4, 12) * 255).round().to(torch.uint8)
    labels, w = _labels(4, 6), torch.ones(4)
    p = patch.clone().requires_grad_(True)
    total, _ = loss_fn(p, u8.float() / 255.0, labels, w, prog_d)
    total.backward()
    exp_d = {"img_size": SIZE, "num_classes": 15, "target_id": 14,
             "nps_factor": 0.01, "tv_factor": 2.5, "tv_floor": 0.1}
    loss, grad = RA.loss_and_grad(patch, u8, labels, w, ref_d, blocks,
                                  weights, exp_d, block_rows=3)
    torch.testing.assert_close(float(total.detach()), float(loss), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(p.grad, grad, rtol=1e-4, atol=1e-7)


def test_detection_rows(victim):
    blocks, weights, model = victim
    det = port.mod("evals.detect").Detector(
        port.network(TINY_CONFIG), port.params(weights),
        anchor_groups=port.decode_anchors(TINY_CONFIG), img_size=SIZE,
        num_classes=15, compute_dtype=torch.float32, device="cpu")
    u8 = (_images(4, 17) * 255).round().to(torch.uint8)
    for conf in (0.4, 0.1):
        dets, valid, _ = det.detect_batch_device(u8.numpy(), conf, 0.4)
        with torch.no_grad():
            heads = det.model(u8.float() / 255.0)
        want = RD.detect_rows(heads, port.decode_anchors(TINY_CONFIG), SIZE,
                              15, conf, 0.4)
        n = 0
        for i in range(4):
            got = dets[i][valid[i]].numpy()
            n += len(got)
            assert RD.rows_gap(got, want[i]) <= 1e-6
        assert n > 0
