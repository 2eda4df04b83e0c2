"""The port's native host routines (``utils/native.py``): where it builds
the library, its four entry points against the JAX package's loader and
against the numpy twins, the ``APFP_NATIVE=0`` opt-out, and the host NMS
(``greedy_nms_host``, ``merge_nms_host``) against the JAX package's, tie
order included.

Tolerances: the IoU matrix atol 1e-6 against numpy (the C++ IoU may
contract into fused multiply-adds; ``tests/test_native.py``'s tolerance)
and equal to the JAX loader's (the same source and flags); kept indices,
occupancy maps and parsed floats exact."""

import os
import subprocess
import sys

import numpy as np
import pytest

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import eot_eval as JEE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import nms as JNMS
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.utils import native as JN
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import eot_eval as PEE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import nms as PNMS
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.utils import native as PN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = PN.__name__.rsplit(".utils", 1)[0]


def boxes_with_duplicates(rng, n):
    """xywh boxes whose scores tie in runs and whose boxes repeat, so
    the stable order decides which one a tie keeps."""
    boxes = np.stack([rng.random(n), rng.random(n),
                      0.05 + 0.25 * rng.random(n),
                      0.05 + 0.25 * rng.random(n)], 1).astype(np.float32)
    boxes[1::4] = boxes[0::4][:len(boxes[1::4])]
    scores = np.round(rng.random(n), 1).astype(np.float32)
    return boxes, scores


def numpy_greedy(boxes, scores, thresh):
    order = np.argsort(-scores, kind="stable")
    iou = PNMS.iou_xywh_matrix(boxes[order], boxes[order])
    alive = np.ones(len(scores), bool)
    keep = []
    for i in range(len(scores)):
        if alive[i]:
            keep.append(order[i])
            alive[i + 1:] &= iou[i, i + 1:] <= thresh
    return np.asarray(keep, np.int64)


@pytest.fixture
def numpy_twins(monkeypatch):
    """Both packages' native loaders disabled: their numpy twins run."""
    for mod in (PN, JN):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)


def test_library_builds_into_the_port_build_dir():
    """The port's library lives under ``<port>/build/`` with a hash of the
    source, flags and host CPU in its name; the loader writes nothing into
    ``native/``."""
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    assert PN.available(), PN.BUILD_ERROR
    path = PN.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, PORT, "build")
    assert os.path.basename(path).startswith("libhost_ops_")
    assert os.path.exists(path)
    assert PN.get_lib()._name == path
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == before


def test_opt_out_takes_the_numpy_twins(tmp_path):
    """``APFP_NATIVE=0``: no library is loaded, every entry point returns
    None, and ``greedy_nms_host`` still keeps what native keeps."""
    code = (
        f"import numpy as np\n"
        f"from {PORT}.utils import native\n"
        f"from {PORT}.ops.nms import greedy_nms_host\n"
        "assert not native.available() and native.BUILD_ERROR is None\n"
        "b = np.array([[.5,.5,.2,.2],[.5,.5,.2,.2],[.1,.1,.1,.1]], np.float32)\n"
        "assert native.greedy_nms(b, np.ones(3, np.float32), .4) is None\n"
        "assert native.iou_xywh_matrix(b, b) is None\n"
        "assert native.interference_map(np.zeros((1, 7), np.float32), 1, 8) is None\n"
        "assert native.parse_floats(b'1 2', 4) is None\n"
        "print(greedy_nms_host(b, np.array([.9,.9,.5], np.float32), .4).tolist())\n")
    env = dict(os.environ, APFP_NATIVE="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[0, 2]"


@pytest.mark.parametrize("n,m", [(17, 9), (1, 40), (0, 3)])
def test_iou_matrix_matches_numpy_and_jax_loader(n, m):
    rng = np.random.default_rng(n + m)
    a = np.stack([rng.random(n), rng.random(n), 0.05 + rng.random(n) * 0.3,
                  0.05 + rng.random(n) * 0.3], 1).astype(np.float32)
    b = np.stack([rng.random(m), rng.random(m), 0.05 + rng.random(m) * 0.3,
                  0.05 + rng.random(m) * 0.3], 1).astype(np.float32)
    got = PN.iou_xywh_matrix(a, b)
    np.testing.assert_allclose(got, PNMS.iou_xywh_matrix(a, b), atol=1e-6)
    np.testing.assert_array_equal(got, JN.iou_xywh_matrix(a, b))


@pytest.mark.parametrize("n,thresh", [(200, 0.4), (64, 0.0), (300, 0.7)])
def test_greedy_nms_matches_numpy_and_jax(n, thresh):
    boxes, scores = boxes_with_duplicates(np.random.default_rng(n), n)
    got = PN.greedy_nms(boxes, scores, thresh)
    np.testing.assert_array_equal(got, numpy_greedy(boxes, scores, thresh))
    np.testing.assert_array_equal(got, JN.greedy_nms(boxes, scores, thresh))
    np.testing.assert_array_equal(PNMS.greedy_nms_host(boxes, scores, thresh),
                                  JNMS.greedy_nms_host(boxes, scores, thresh))


@pytest.mark.parametrize("n", [0, 1, 150])
def test_greedy_nms_host_both_paths_keep_the_same(n, monkeypatch):
    """The port's ``greedy_nms_host`` keeps the same indices through the
    native routine and through its numpy twin."""
    boxes, scores = boxes_with_duplicates(np.random.default_rng(7), n)
    native_kept = PNMS.greedy_nms_host(boxes, scores, 0.45)
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "_tried", True)
    np.testing.assert_array_equal(PNMS.greedy_nms_host(boxes, scores, 0.45),
                                  native_kept)


@pytest.mark.parametrize("se", [0, 4, 9, 40])
def test_interference_map_matches_jax_loader_and_twin(se):
    labels = np.array([[0.5, 0.5, 0.2, 0.2, 0.9, 0.9, 3],
                       [0.2, 0.8, 0.1, 0.12, 0.8, 0.9, 4],
                       [0.82, 0.25, 0.15, 0.1, 0.7, 0.9, 1]], np.float32)
    got = PN.interference_map(labels, se, 64)
    np.testing.assert_array_equal(got, JN.interference_map(labels, se, 64))
    lib, PN._lib = PN._lib, None
    try:
        twin = PEE.interference_map(labels, se, 64)
    finally:
        PN._lib = lib
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got, JEE.interference_map(labels, se, 64))


def test_parse_floats_matches_jax_loader():
    text = b"3 0.5 0.25 0.125 0.0625\n14 0.1 0.2 0.3 0.4\n  -1e-3\tinf\n"
    got = PN.parse_floats(text, 64)
    np.testing.assert_array_equal(got, JN.parse_floats(text, 64))
    np.testing.assert_array_equal(
        got, np.array(text.split(), np.float32))
    assert len(PN.parse_floats(text, 4)) == 4


@pytest.mark.parametrize("agnostic,merge", [(False, True), (True, True),
                                            (False, False)])
def test_merge_nms_host_matches_jax(agnostic, merge):
    rng = np.random.default_rng(3)
    n, c = 120, 6
    boxes, _ = boxes_with_duplicates(rng, n)
    obj = np.round(rng.random(n), 1).astype(np.float32)
    cls = np.round(rng.random((n, c)), 1).astype(np.float32)
    got = PNMS.merge_nms_host(boxes, obj, cls, 0.2, 0.4, agnostic, 50, merge)
    want = JNMS.merge_nms_host(boxes, obj, cls, 0.2, 0.4, agnostic, 50, merge)
    assert got.shape == want.shape and got.shape[1] == 7 and len(got)
    np.testing.assert_array_equal(got, want)


def test_merge_nms_host_empty_and_below_threshold(numpy_twins):
    empty = PNMS.merge_nms_host(np.zeros((0, 4), np.float32),
                                np.zeros(0, np.float32),
                                np.zeros((0, 3), np.float32))
    assert empty.shape == (0, 7)
    low = PNMS.merge_nms_host(np.full((2, 4), 0.5, np.float32),
                              np.full(2, 0.1, np.float32),
                              np.full((2, 3), 0.1, np.float32))
    assert low.shape == (0, 7)
