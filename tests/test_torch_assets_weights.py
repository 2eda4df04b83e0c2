"""The port's assets, cfg parsing and darknet weight I/O against the JAX
package's. All comparisons are exact: these are data, not arithmetic."""

import os

import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import data as JD
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import models as JM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import weights as JW
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import data as PD
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
MINI = (os.path.join(FIX, "refparity", "mini_yolov3_dota.cfg"),
        os.path.join(FIX, "refparity", "mini_yolov3_dota.weights"))
SLIM = (os.path.join(FIX, "refparity_slim", "yolov3_dota_slim.cfg"),
        os.path.join(FIX, "refparity_slim", "yolov3_dota_slim.weights"))


def test_assets_match():
    assert PD.load_class_names() == JD.load_class_names()
    for quirk in (True, False):
        np.testing.assert_array_equal(PD.load_anchor_groups(quirk=quirk),
                                      JD.load_anchor_groups(quirk=quirk))
    # the quirk reverses the group order (stride-32 head gets the small
    # anchors)
    q = PD.load_anchor_groups()
    assert q[0, 0, 0] < q[2, 0, 0]
    np.testing.assert_array_equal(PD.load_printable_colors(),
                                  JD.load_printable_colors())
    assert PD.load_printable_colors().shape == (30, 3)


@pytest.mark.parametrize("which", ["yolov3", "yolov3_slim", "tiny", "mini",
                                   "slim"])
def test_cfg_blocks_and_network_match(which):
    if which == "yolov3":
        src = (PM.yolov3_blocks(), JM.yolov3_blocks())
    elif which == "yolov3_slim":
        src = (PM.yolov3_blocks(width_mult=0.25),
               JM.yolov3_blocks(width_mult=0.25))
    elif which == "tiny":
        src = (PM.tiny_test_blocks(), JM.tiny_test_blocks())
    else:
        cfg = MINI[0] if which == "mini" else SLIM[0]
        src = (PM.parse_darknet_cfg(cfg), JM.parse_darknet_cfg(cfg))
    assert src[0] == src[1]
    pnet, jnet = PM.build_network(src[0]), JM.build_network(src[1])
    # same static structure, field by field
    assert len(pnet.layers) == len(jnet.layers)
    for pl, jl in zip(pnet.layers, jnet.layers):
        pd, jd = vars(pl).copy(), vars(jl).copy()
        pc, jc = pd.pop("conv"), jd.pop("conv")
        assert pd == jd
        assert (pc is None) == (jc is None)
        if pc is not None:
            assert vars(pc) == vars(jc)
    for f in ("width", "height", "channels", "num_classes", "yolo_indices",
              "saved_outputs"):
        assert getattr(pnet, f) == getattr(jnet, f)


def test_yolov3_is_75_convs():
    net = PM.build_network(PM.yolov3_blocks())
    assert len(PM.conv_specs(net)) == 75
    assert net.num_classes == 15 and len(net.yolo_indices) == 3


@pytest.mark.parametrize("which", ["mini", "slim"])
def test_weights_load_matches_jax_bit_for_bit(which):
    cfg, weights = MINI if which == "mini" else SLIM
    jnet = JM.build_network(JM.parse_darknet_cfg(cfg))
    pnet = PM.build_network(PM.parse_darknet_cfg(cfg))
    jparams, jheader = JW.load_darknet_weights(jnet, weights)
    pparams, pheader = PM.load_darknet_weights(pnet, weights)
    np.testing.assert_array_equal(pheader, jheader)
    want = PM.params_from_jax(jparams)
    assert pparams.keys() == want.keys()
    for k in want:
        assert pparams[k].keys() == want[k].keys()
        for f in want[k]:
            assert pparams[k][f].dtype == torch.float32
            assert torch.equal(pparams[k][f], want[k][f]), (k, f)
    # BN folding gives the JAX package's folded tree up to the last ulp
    # (XLA's CPU compiler may round gamma / sqrt(var + eps) differently
    # from torch's separately rounded sqrt and divide)
    pf = PM.fold_bn(pnet, pparams)
    jf = PM.params_from_jax(JM.fold_bn(jnet, jparams))
    for k in jf:
        for f in ("w", "b"):
            np.testing.assert_allclose(pf[k][f].numpy(), jf[k][f].numpy(),
                                       rtol=1e-6, atol=1e-30, err_msg=k)


def test_weights_io_roundtrip(tmp_path):
    cfg, weights = MINI
    net = PM.build_network(PM.parse_darknet_cfg(cfg))
    params, header = PM.load_darknet_weights(net, weights)
    out = tmp_path / "rt.weights"
    PM.save_darknet_weights(net, params, out, header)
    assert out.read_bytes() == open(weights, "rb").read()
    params2, header2 = PM.load_darknet_weights(net, out)
    np.testing.assert_array_equal(header2, header)
    for k in params:
        for f in params[k]:
            assert torch.equal(params2[k][f], params[k][f])


def test_weights_io_random_init_roundtrip(tmp_path):
    net = PM.build_network(PM.tiny_test_blocks())
    params = PM.init_params(net, 3)
    out = tmp_path / "tiny.weights"
    PM.save_darknet_weights(net, params, out)
    params2, header = PM.load_darknet_weights(net, out)
    np.testing.assert_array_equal(header, [0, 2, 0, 0, 0])
    for k in params:
        for f in params[k]:
            assert torch.equal(params2[k][f], params[k][f])


def test_weights_io_detects_truncation_and_leftovers(tmp_path):
    net = PM.build_network(PM.tiny_test_blocks())
    out = tmp_path / "tiny.weights"
    PM.save_darknet_weights(net, PM.init_params(net, 0), out)
    raw = out.read_bytes()
    (tmp_path / "short.weights").write_bytes(raw[:-4])
    with pytest.raises(ValueError, match="truncated"):
        PM.load_darknet_weights(net, tmp_path / "short.weights")
    (tmp_path / "long.weights").write_bytes(raw + b"\0" * 8)
    with pytest.raises(ValueError, match="unread"):
        PM.load_darknet_weights(net, tmp_path / "long.weights")


def test_init_params_draws_in_jax_layout():
    """init_params draws HWIO with numpy's generator, then transposes:
    the same seed gives the same numbers in the JAX layout."""
    net = PM.build_network(PM.tiny_test_blocks())
    params = PM.init_params(net, 11)
    rng = np.random.default_rng(11)
    for spec in PM.conv_specs(net):
        fan_in = spec.in_ch * spec.size * spec.size
        w = rng.standard_normal((spec.size, spec.size, spec.in_ch,
                                 spec.filters), dtype=np.float32)
        w = w * np.float32(np.sqrt(2.0 / fan_in))
        np.testing.assert_array_equal(
            params[f"conv_{spec.index}"]["w"].numpy(),
            w.transpose(3, 2, 0, 1))
        assert ("gamma" in params[f"conv_{spec.index}"]) == spec.bn


def test_pad_and_scale_matches(tmp_path):
    from PIL import Image
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.data import dataset as JDS
    rng = np.random.default_rng(4)
    img = Image.fromarray((rng.random((50, 80, 3)) * 255).astype(np.uint8))
    path = tmp_path / "t.png"
    img.save(path)
    labels = np.array([[1, 0.5, 0.5, 0.2, 0.3]], np.float32)
    a = PD.pad_and_scale(PD.load_image_rgb(str(path)), labels, 64)
    b = JDS.pad_and_scale(JDS.load_image_rgb(str(path)), labels, 64)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
