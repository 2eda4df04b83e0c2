"""The plain reference against the program at a tiny size on the CPU, in
float32: the victim's heads and input gradient (on the tiny YOLOv3-like
graph and on a small graph of YOLOv4's layer kinds), the EOT composite
from the same draws, a training step's loss and patch gradient, and the
detection rows after decode, threshold and NMS. Then the reference's own
reading of a cfg: Mish, darknet's maxpool rule, and the refusal of what
its forward does not implement."""

import numpy as np
import pytest
import torch

from benchmark import inputs, port
from benchmark.reference import attack as RA
from benchmark.reference import cfg as RC
from benchmark.reference import darknet as R
from benchmark.reference import detect as RD
from benchmark.weights import victim as make_victim

from .conftest import TINY, TINY_CONFIG, cfg_text

SIZE = 64
# the tiny configuration on a graph of YOLOv4's layer kinds: Mish, a CSP
# split, SPP, a 2/1 maxpool, heads stride 8 first with scale_x_y
MISH = dict(TINY, cfgfile="mish_csp_spp.cfg",
            cfg_text=cfg_text("mish_csp_spp.cfg"))


def _victim(config):
    blocks, weights = make_victim(config, 11, "cpu")
    model = port.mod("models.darknet").Darknet(
        port.network(config), port.params(weights), torch.float32,
        device="cpu").eval()
    return blocks, weights, model


@pytest.fixture(scope="module")
def victim():
    return _victim(TINY)


def _images(n, seed=3):
    return inputs.smooth_tiles(n, SIZE, seed, "cpu").float() / 255.0


def _rel(got, want):
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


# The tiny graph's leaky walk runs the program's float32 operations in the
# program's order, so it is held element by element. The program's Mish
# is x tanh(logaddexp(x, 0)), the reference's darknet's x tanh(softplus(x)):
# they differ by an ulp here and there, which the graph's 46 layers grow
# to 1.1-1.3e-6 of a head's norm and 6e-7 of the input gradient's (weight
# seeds 11-13). So that case is held to 1e-5 of the norm: room for 8x that
# rounding, while a 2/1 maxpool padded on the wrong side, or Mish run as
# leaky or linear, reads 0.31-0.62.
@pytest.mark.parametrize("config,elementwise", [(TINY, True), (MISH, False)],
                         ids=["tiny", "mish_csp_spp"])
def test_heads_and_input_gradient(config, elementwise):
    blocks, weights, model = _victim(config)
    x = _images(3)
    xp = x.clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    got = model(xp)
    want = R.forward(blocks, weights, xr)
    assert [w.shape[1] for w in want] == ([2, 4, 8] if elementwise
                                          else [8, 4, 2])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.detach(), w.detach()) <= 1e-5
        if elementwise:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    cot = [torch.randn(w.shape, generator=torch.Generator().manual_seed(i))
           for i, w in enumerate(want)]
    sum((g * c).sum() for g, c in zip(got, cot)).backward()
    sum((w * c).sum() for w, c in zip(want, cot)).backward()
    assert _rel(xp.grad, xr.grad) <= 1e-5
    if elementwise:
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
        port.network(TINY), port.params(weights),
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


def test_mish_is_darknets():
    """The reference's Mish against darknet's ``activate_array_mish``
    (softplus with its threshold 20) in float64: float32 rounding
    apart."""
    x = torch.linspace(-30.0, 30.0, 6001)
    got = R._activate(x, "mish", None).double()
    xd = x.double()
    sp = torch.where(xd > 20, xd, torch.where(xd < -20, torch.exp(xd),
                                              torch.log1p(torch.exp(xd))))
    want = xd * torch.tanh(sp)
    assert torch.all(torch.abs(got - want)
                     <= 4 * 2.0 ** -24 * torch.abs(want) + 1e-30)


def _pool_cfg(side, size, stride, extra=""):
    return (f"[net]\nwidth={side}\nheight={side}\nchannels=3\n\n"
            f"[maxpool]\nsize={size}\nstride={stride}\n{extra}\n"
            "[yolo]\nclasses=1\n")


@pytest.mark.parametrize("side,size,stride", [
    (13, 2, 1), (13, 5, 1), (13, 9, 1), (13, 13, 1), (13, 2, 2), (12, 2, 2),
    (13, 3, 2)])
def test_maxpool_is_darknets(side, size, stride):
    """darknet's ``forward_maxpool_layer``, by its loops: the output side
    ``(w + padding - size) // stride + 1`` with ``padding = size - 1``,
    the window of output j from ``j * stride - padding // 2``, places
    outside the input left out."""
    _, blocks = RC.parse(_pool_cfg(side, size, stride))
    x = torch.rand(2, side, side, 3, generator=torch.Generator().manual_seed(
        size * 31 + stride))
    (got,) = R.forward(blocks, {}, x)
    pad = size - 1
    n = (side + pad - size) // stride + 1
    xn = x.numpy()
    want = np.full((2, n, n, 3), -np.inf, np.float32)
    for i in range(n):
        for j in range(n):
            for di in range(size):
                for dj in range(size):
                    r = i * stride - pad // 2 + di
                    c = j * stride - pad // 2 + dj
                    if 0 <= r < side and 0 <= c < side:
                        want[:, i, j] = np.maximum(want[:, i, j],
                                                   xn[:, r, c])
    assert got.shape == (2, n, n, 3)
    assert torch.equal(got, torch.from_numpy(want))


def test_route_joins_any_sources():
    """A route of four sources, relative and absolute, concatenates them
    in its order; a shortcut takes an absolute source as well."""
    text = ("[net]\nwidth=8\nheight=8\nchannels=3\n\n"
            "[maxpool]\nsize=3\nstride=1\n\n"      # 0
            "[maxpool]\nsize=5\nstride=1\n\n"      # 1, of 0
            "[route]\nlayers=-1,0,-2,1\n\n"         # 2: 1, 0, 0, 1
            "[route]\nlayers=0\n\n"                 # 3: 0
            "[shortcut]\nfrom=1\nactivation=linear\n\n"  # 4: 3 + 1
            "[route]\nlayers=-3,-1\n\n"             # 5: 2, 4
            "[yolo]\nclasses=1\n")
    _, blocks = RC.parse(text)
    x = torch.rand(1, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    (got,) = R.forward(blocks, {}, x)
    xc = x.permute(0, 3, 1, 2)
    p3 = torch.nn.functional.max_pool2d(xc, 3, 1, 1)
    p5 = torch.nn.functional.max_pool2d(p3, 5, 1, 2)
    want = torch.cat([p5, p3, p3, p5, p3 + p5], 1).permute(0, 2, 3, 1)
    assert torch.equal(got, want)


_NET = "[net]\nwidth=32\nheight=32\nchannels=3\n\n"
_CONV = ("[convolutional]\nbatch_normalize=1\nfilters=8\nsize=3\n"
         "stride=1\npad=1\nactivation=leaky\n\n")


@pytest.mark.parametrize("text,named", [
    (_CONV + "[convolutional]\nfilters=8\nsize=1\nactivation=swish\n",
     "activation 'swish'"),
    (_CONV.replace("leaky", "relu"), "activation 'relu'"),
    (_CONV.replace("pad=1", "pad=1\ngroups=2"), "groups=2"),
    (_CONV.replace("pad=1", "pad=1\ndilation=2"), "dilation=2"),
    (_CONV.replace("pad=1", "padding=2"), "padding=2"),
    (_CONV + "[route]\nlayers=-1\ngroups=2\ngroup_id=1\n", "groups=2"),
    (_CONV + "[route]\nlayers=-1\ngroups=1\n", "groups=1"),
    (_CONV + _CONV + "[sam]\nfrom=-2\n", "[sam]"),
    (_CONV + _CONV + "[scale_channels]\nfrom=-2\n", "[scale_channels]"),
    (_CONV + "[shortcut]\nfrom=-1\nweights_type=per_feature\n",
     "weights_type=per_feature"),
    (_CONV + "[maxpool]\nsize=2\nstride=2\nmaxpool_depth=1\n",
     "maxpool_depth=1"),
    (_CONV + "[upsample]\nstride=2\nscale=0.5\n", "scale=0.5"),
    # darknet's default activation is logistic, which the forward lacks
    (_CONV + "[convolutional]\nfilters=8\nsize=1\n", "activation 'logistic'"),
])
def test_unimplemented_raises_naming_it(text, named):
    with pytest.raises(ValueError) as e:
        RC.parse(_NET + text)
    assert named in str(e.value)


def test_decode_keys_are_read():
    """A [yolo] layer's decode and training keys, and [net]'s schedule,
    leave the forward as it is."""
    text = (_NET.replace("channels=3", "channels=3\nmosaic=1\nburn_in=1000")
            + _CONV + "[route]\nlayers=-1\n\n"
            + "[convolutional]\nfilters=18\nsize=1\nactivation=linear\n\n"
            + "[yolo]\nmask=0,1,2\nanchors=1,2, 3,4, 5,6\nclasses=1\n"
            + "num=3\nscale_x_y=1.05\niou_loss=ciou\nnms_kind=greedynms\n"
            + "beta_nms=0.6\niou_normalizer=0.07\nmax_delta=5\n")
    info, blocks = RC.parse(text)
    assert info == {"width": 32, "height": 32, "channels": 3}
    assert [b["type"] for b in blocks] == ["conv", "route", "conv", "yolo"]
    assert blocks[-1] == {"type": "yolo", "scale": 0, "classes": 1}
