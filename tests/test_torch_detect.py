"""The whole detection slice on the CPU: the port's Detector against the
JAX package's Detector on the same weights and images (float32), and the
mini victim's reference goldens through the port.

Rows are matched 1-1 when all 7 columns agree within 1e-3, the
tolerance of tests/test_refparity.py: both frameworks run float32
convolutions that sum in different orders, and a box coordinate is an
exp() of a head value."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import evals as JE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import models as JM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import weights as JW
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import evals as PE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM

MINI_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "refparity")


def _match_count(ours, ref, atol=1e-3):
    """Greedy 1-1 matching: rows agree when all 7 columns are within
    atol. Returns number matched."""
    ours = np.asarray(ours, np.float32).reshape(-1, 7)
    ref = np.asarray(ref, np.float32).reshape(-1, 7)
    if len(ref) == 0 or len(ours) == 0:
        return 0
    used = np.zeros(len(ref), bool)
    matched = 0
    for row in ours:
        d = np.abs(ref - row).max(axis=1)
        d[used] = np.inf
        j = int(np.argmin(d))
        if d[j] <= atol:
            used[j] = True
            matched += 1
    return matched


def _same_rows(ours, ref):
    assert len(ours) == len(ref)
    assert _match_count(ours, ref) == len(ref)


def _tiles():
    return np.stack([np.asarray(Image.open(os.path.join(
        MINI_DIR, f"tile_{i}.png")).convert("RGB"), np.float32) / 255.0
        for i in range(3)])


@pytest.fixture(scope="module", params=["tiny", "mini"])
def pair(request):
    """(JAX Detector, port Detector on the CPU, images, conf)."""
    if request.param == "tiny":
        net = JM.build_network(JM.tiny_test_blocks())
        params = JM.fold_bn(net, JM.init_params(net, jax.random.PRNGKey(5)))
        pnet = PM.build_network(PM.tiny_test_blocks())
        images = np.random.default_rng(0).random((3, 64, 64, 3),
                                                 dtype=np.float32)
        size, conf, max_cand = 64, 0.05, 256
    else:
        cfg = os.path.join(MINI_DIR, "mini_yolov3_dota.cfg")
        net = JM.build_network(JM.parse_darknet_cfg(cfg))
        params, _ = JW.load_darknet_weights(
            net, cfg.replace(".cfg", ".weights"))
        params = JM.fold_bn(net, params)
        pnet = PM.build_network(PM.parse_darknet_cfg(cfg))
        images = _tiles()
        size, conf, max_cand = 320, 0.2, 4096
    jdet = JE.Detector(net, params, img_size=size,
                       compute_dtype=jnp.float32, max_candidates=max_cand)
    pdet = PE.Detector(pnet, PM.params_from_jax(params), img_size=size,
                       compute_dtype=torch.float32,
                       max_candidates=max_cand, device="cpu")
    return jdet, pdet, images, conf


def test_detect_batch_matches_jax(pair):
    jdet, pdet, images, conf = pair
    got = pdet.detect_batch(images, conf, 0.4)
    want = jdet.detect_batch(images, conf, 0.4)
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape[1] == 7
        _same_rows(g, w)
    _same_rows(pdet.detect(images[0], conf, 0.4), want[0])


def test_detect_batch_saturation_reruns_unpruned(pair):
    """A candidate cap below the above-threshold count forces the
    un-pruned re-run; the result equals the uncapped one."""
    jdet, pdet, images, _ = pair
    capped = PE.Detector(pdet.net, pdet.model.folded_params(),
                         img_size=pdet.img_size,
                         compute_dtype=torch.float32, max_candidates=8,
                         device="cpu")
    full = pdet.detect_batch(images, 0.0, 0.4)
    got = capped.detect_batch(images, 0.0, 0.4)
    for g, w in zip(got, full):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_detect_batch_device_matches_jax(pair, wire):
    jdet, pdet, images, conf = pair
    if wire == "uint8":
        images = np.clip(images * 255.0 + 0.5, 0, 255).astype(np.uint8)
    dets, valid, sat = pdet.detect_batch_device(images, conf, 0.4)
    jd, jv, js = (np.asarray(a) for a in
                  jdet.detect_batch_device(images, conf, 0.4))
    assert tuple(dets.shape) == (len(images), 300, 7)
    np.testing.assert_array_equal(sat.numpy(), js)
    dets, valid = dets.numpy(), valid.numpy()
    for i in range(len(images)):
        _same_rows(dets[i][valid[i]], jd[i][jv[i]])
        assert not dets[i][~valid[i]].any()
    # the device path agrees with the exact host path when unsaturated
    host = pdet.detect_batch(
        images.astype(np.float32) / 255.0 if wire == "uint8" else images,
        conf, 0.4)
    for i in range(len(images)):
        _same_rows(dets[i][valid[i]], host[i])


@pytest.fixture(scope="module")
def mini_port():
    """(goldens, the port's float32 CPU Detector on the mini victim, its
    weights loaded with the port's own loader)."""
    with open(os.path.join(MINI_DIR, "golden_boxes.json")) as f:
        golden = json.load(f)
    cfg = os.path.join(MINI_DIR, "mini_yolov3_dota.cfg")
    net = PM.build_network(PM.parse_darknet_cfg(cfg))
    params, _ = PM.load_darknet_weights(net, cfg.replace(".cfg", ".weights"))
    return golden, PE.Detector(net, params, img_size=golden["img_size"],
                               num_classes=golden["num_classes"],
                               compute_dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("key,conf", [("conf04", 0.4), ("conf02", 0.2)])
def test_mini_goldens_through_the_port(mini_port, key, conf):
    """The mini victim's reference outputs (do_detect of the reference's
    own torch code, tests/fixtures/refparity) match 1-1 within 1e-3."""
    golden, det = mini_port
    n = 0
    for tile, entry in golden["tiles"].items():
        img = np.asarray(Image.open(os.path.join(MINI_DIR, tile)).convert(
            "RGB"), np.float32) / 255.0
        ours = det.detect(img, conf, golden["nms_thresh"])
        _same_rows(ours, entry[key])
        n += len(entry[key])
    assert n > 0


def test_mini_prenms_candidates_conf001_through_the_port(mini_port):
    """The decode chain itself, tie-free: every reference pre-NMS
    candidate at conf 0.01 appears 1-1 within 1e-3 in the port's
    un-pruned candidate rows."""
    golden, det = mini_port
    images = _tiles()
    vals = det._infer_full(torch.from_numpy(images)).numpy()
    for i, (tile, entry) in enumerate(sorted(golden["tiles"].items())):
        assert tile == f"tile_{i}.png"
        ours = vals[i][vals[i][:, 7] > 0.01][:, :7]
        _same_rows(ours, entry["prenms001"])


def test_detections_to_label_rows():
    dets = np.arange(14, dtype=np.float32).reshape(2, 7)
    np.testing.assert_array_equal(PE.detections_to_label_rows(dets), dets)
    rows = PE.detections_to_label_rows(dets, with_conf=False)
    np.testing.assert_array_equal(rows, JE.detections_to_label_rows(
        dets, with_conf=False))
    assert rows.shape == (2, 5) and rows[0, 0] == 6
