"""Box decode and NMS: the port against the JAX package on the same
inputs. Index outputs (NMS survivors, validity, saturation) must be
equal; float outputs agree to float32 rounding (rtol 1e-6: sigmoid and
exp are separately rounded library calls in the two frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.data import load_anchor_groups
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import decode as JDEC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import nms as JN
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import decode as PDEC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import nms as PN


def _heads(rng, b=2, sizes=(2, 4, 8), c=15):
    return [(rng.standard_normal((b, s, s, 3 * (5 + c))) * 2
             ).astype(np.float32) for s in sizes]


def test_decode_matches_jax():
    rng = np.random.default_rng(0)
    heads = _heads(rng)
    anchors = load_anchor_groups()
    want = JDEC.decode_all_heads([jnp.asarray(h) for h in heads], anchors,
                                 (64, 64), 15)
    got = PDEC.decode_all_heads([torch.from_numpy(h) for h in heads],
                                anchors, (64, 64), 15)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    assert got[0].shape == (2, 3 * (4 + 16 + 64), 4)
    one = PDEC.decode_head(torch.from_numpy(heads[1]), anchors[1], (64, 64))
    jone = JDEC.decode_head(jnp.asarray(heads[1]), anchors[1], (64, 64))
    for g, w in zip(one, jone):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_head_cell_scores_match_jax():
    head = _heads(np.random.default_rng(1))[2]
    for g, w in zip(PDEC.head_cell_scores(torch.from_numpy(head)),
                    JDEC.head_cell_scores(jnp.asarray(head))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _boxes(rng, b, n):
    xy = rng.random((b, n, 2)) * 0.6 + 0.2
    wh = rng.random((b, n, 2)) * 0.25 + 0.05
    return np.concatenate([xy, wh], -1).astype(np.float32)


def test_iou_matrix_matches_jax():
    rng = np.random.default_rng(2)
    a, b = _boxes(rng, 1, 20)[0], _boxes(rng, 1, 30)[0]
    want = np.asarray(JN.iou_xywh_matrix(jnp.asarray(a), jnp.asarray(b),
                                         xp=jnp))
    np.testing.assert_allclose(PN.iou_xywh_matrix(a, b), want, rtol=1e-6)
    np.testing.assert_allclose(
        PN.iou_xywh_matrix(torch.from_numpy(a), torch.from_numpy(b),
                           xp=torch).numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_nms_host_matches_jax(seed):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, 1, 200)[0]
    scores = rng.random(200).astype(np.float32)
    scores[::7] = scores[3]  # ties resolve to the lower index
    got = PN.greedy_nms_host(boxes, scores, 0.4)
    want = JN.greedy_nms_host(boxes, scores, 0.4)
    np.testing.assert_array_equal(got, want)
    assert len(PN.greedy_nms_host(boxes[:0], scores[:0], 0.4)) == 0


def _device_case(seed, b=3, n=40):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, b, n)
    scores = rng.random((b, n)).astype(np.float32)
    scores[1, 5:] = 0.0          # image 1: only 5 positive candidates
    scores[2, ::3] = scores[2, 1]  # image 2: ties
    return boxes, scores


def _both(boxes, scores, max_det):
    want = [np.asarray(a) for a in JN.greedy_nms_device_batch(
        jnp.asarray(boxes), jnp.asarray(scores), 0.4, max_det)]
    got = [t.numpy() for t in PN.greedy_nms_device_batch(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.4, max_det)]
    return got, want


@pytest.mark.parametrize("max_det", [4, 10])
def test_greedy_nms_device_batch_matches_jax(max_det):
    """max_det 4: k = 32 < n = 40, so the prune is real and saturates on
    images with more than 32 positive scores (0 and 2) but not on image
    1; max_det 10: k = n, never saturated."""
    boxes, scores = _device_case(3)
    got, want = _both(boxes, scores, max_det)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    sat = got[2]
    if max_det == 4:
        assert sat.tolist() == [True, False, True]
    else:
        assert not sat.any()
    assert got[1].any(axis=1).all()


def test_greedy_nms_device_serial_fallback(monkeypatch):
    """Capping Jacobi at one pass forces the exact serial scan whenever
    anything is suppressed; both frameworks then agree with each other
    and with the uncapped result."""
    boxes, scores = _device_case(5)
    uncapped, _ = _both(boxes, scores, 10)
    monkeypatch.setattr(JN, "JACOBI_MAX_PASSES", 1)
    monkeypatch.setattr(PN, "JACOBI_MAX_PASSES", 1)
    _, converged = PN._jacobi_alive(*PN._nms_prep(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.4, 10)[1:], 1)
    assert not bool(converged.all())
    got, want = _both(boxes, scores, 10)
    for g, w, u in zip(got, want, uncapped):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, u)


def test_greedy_nms_device_single_matches_host():
    rng = np.random.default_rng(7)
    boxes = _boxes(rng, 1, 30)
    scores = rng.random((1, 30)).astype(np.float32)
    idx, valid, sat = PN.greedy_nms_device(
        torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), 0.4, 300)
    jidx, jvalid, jsat = JN.greedy_nms_device(
        jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.4, 300)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert bool(sat) == bool(jsat) is False
    host = PN.greedy_nms_host(boxes[0], scores[0], 0.4)
    np.testing.assert_array_equal(idx.numpy()[valid.numpy()], host)
