"""The port's creation-attack metrics (``evals/metrics.py``) and
detection drawing (``evals/plotting.py``) against the JAX package's, on
the same seeded label sets, from label dirs and from in-memory arrays.

Tolerances: counts and per-class gaps exact; floats within 1e-7
(both are numpy on the host, so they are in fact equal); drawn images
byte for byte."""

import io
import math
import os

import numpy as np
import pytest
from PIL import Image

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import evals as JE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import evals as PE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.data import labels as L


def seeded_sets(seed, n_images=6):
    """(pred 7-col, gt 7-col, pred 5-col, gt 5-col) lists of arrays from
    one seed; image 1 has no rows anywhere (an empty label file)."""
    rng = np.random.default_rng(seed)

    def rows7(n):
        r = np.zeros((n, 7), np.float32)
        r[:, 0:2] = rng.uniform(0.05, 0.95, (n, 2))
        r[:, 2:4] = rng.uniform(0.02, 0.3, (n, 2))
        r[:, 4:6] = rng.uniform(0.0, 1.0, (n, 2))
        r[:, 6] = rng.integers(0, 15, n)
        return r

    gt7 = [rows7(rng.integers(1, 6)) for _ in range(n_images)]
    # predictions: the ground truth, a little jittered, plus created rows
    pred7 = [np.concatenate([g + np.float32(0.01) * rng.standard_normal(
        g.shape).astype(np.float32) * (np.arange(7) < 4),
        rows7(rng.integers(0, 8))]) for g in gt7]
    for p in pred7:
        p[:, 6] = np.clip(np.round(p[:, 6]), 0, 14)
    gt7[1] = gt7[1][:0]
    pred7[1] = pred7[1][:0]
    gt5 = [np.concatenate([g[:, 6:7], g[:, 0:4]], 1)[g[:, 4] > 0.4]
           for g in gt7]
    pred5 = [np.concatenate([p[:, 6:7], p[:, 0:4]], 1)[p[:, 4] > 0.4]
             for p in pred7]
    return pred7, gt7, pred5, gt5


def write_dir(path, arrays):
    os.makedirs(path, exist_ok=True)
    for i, rows in enumerate(arrays):
        L.write_label_file(os.path.join(path, f"img{i}.txt"), rows)
    return str(path)


def assert_same(a, b):
    if isinstance(a, float) or isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b)
        else:
            assert a == pytest.approx(b, abs=1e-7, rel=0)
    else:
        assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("source", ["dirs", "arrays"])
def test_metrics_equal_jax(seed, source, tmp_path):
    pred7, gt7, pred5, gt5 = seeded_sets(seed)
    if source == "dirs":
        pred7, gt7 = write_dir(tmp_path / "p7", pred7), write_dir(
            tmp_path / "g7", gt7)
        pred5, gt5 = write_dir(tmp_path / "p5", pred5), write_dir(
            tmp_path / "g5", gt5)
    n = 6
    for fn, args in [
            ("instance_count", (pred7,)), ("instance_count", (gt5, 5)),
            ("conf_sum", (pred7,)), ("conf_sum", (gt7,)),
            ("m1_average_instances_created", (pred7, gt7, n)),
            ("m2_average_confidence_created", (pred7, gt7)),
            ("precision_recall", (pred7, gt5, 0.4)),
            ("precision_recall", (pred7, gt5, 0.01, 0.3)),
            ("average_precision", (pred7, gt5)),
            ("average_precision", (pred7, gt5, 0.5, 3)),
            ("mean_average_precision", (pred7, gt5))]:
        got, want = getattr(PE, fn)(*args), getattr(JE, fn)(*args)
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                assert_same(g, w)
        else:
            assert_same(got, want)
    for fn in ("instances_per_class", "m4_per_class_gap"):
        args = (pred7,) if fn == "instances_per_class" else (pred7, gt7)
        np.testing.assert_array_equal(getattr(PE, fn)(*args),
                                      getattr(JE, fn)(*args))
    got = PE.creation_metrics_report(pred5, gt5, pred7, gt7, n)
    want = JE.creation_metrics_report(pred5, gt5, pred7, gt7, n)
    assert list(got) == list(want)
    for k in want:
        assert_same(got[k], want[k])


def test_m2_quirk_nan_when_nothing_created(tmp_path):
    """No row created at 0.4: M2@0.4 (the height-column quirk) is NaN in
    both, as is M2@0.01 when the 7-col counts tie."""
    _, gt7, _, gt5 = seeded_sets(4)
    got = PE.creation_metrics_report(gt5, gt5, gt7, gt7, 6)
    want = JE.creation_metrics_report(gt5, gt5, gt7, gt7, 6)
    for k in ("M2_avg_conf_created_04_quirk", "M2_avg_conf_created_001"):
        assert math.isnan(got[k]) and math.isnan(want[k])
    assert got["M1_avg_instances_created_04"] == 0.0


def test_m2_quirk_sums_the_height_column(tmp_path):
    """The quirk of record: M2@0.4 sums column 4 of the 5-col files (the
    box height)."""
    gt5 = [np.array([[3, 0.5, 0.5, 0.1, 0.2]], np.float32)]
    pred5 = [np.array([[3, 0.5, 0.5, 0.1, 0.2],
                       [4, 0.2, 0.2, 0.1, 0.35]], np.float32)]
    rep = PE.creation_metrics_report(pred5, gt5, pred5, gt5, 1)
    assert rep["M2_avg_conf_created_04_quirk"] == pytest.approx(0.35)
    assert rep == pytest.approx(
        JE.creation_metrics_report(pred5, gt5, pred5, gt5, 1))


def test_precision_recall_eval_list_arithmetic():
    """Proposals counted on obj*cls, GT matched over all rows, +1e-8 in
    the denominators (utils_self.eval_list)."""
    gt = [np.array([[3, 0.5, 0.5, 0.2, 0.2]], np.float32)]
    pred = [np.array([
        [0.5, 0.5, 0.2, 0.2, 0.9, 0.9, 3],
        [0.1, 0.1, 0.05, 0.05, 0.9, 0.9, 4],
        [0.9, 0.9, 0.05, 0.05, 0.1, 0.2, 4],
    ], np.float32)]
    p, r = PE.precision_recall(pred, gt, conf_thresh=0.4)
    assert p == 1.0 / (2.0 + 1e-8) and r == 1.0 / (1.0 + 1e-8)
    assert (p, r) == JE.precision_recall(pred, gt, conf_thresh=0.4)


@pytest.mark.parametrize("use_07", [False, True])
def test_ap_from_pr_known_values(use_07):
    assert PE.ap_from_pr(np.array([0.5, 1.0]), np.array([1.0, 1.0]),
                         use_07) == pytest.approx(1.0)
    rec, prec = np.array([0.2, 0.4, 0.4, 0.9]), np.array([1.0, 0.5, 0.7, 0.3])
    got = PE.ap_from_pr(rec, prec, use_07)
    assert got == JE.ap_from_pr(rec, prec, use_07)
    if not use_07:
        # max-precision envelope 1, .7, .7, .3 over recall steps .2 .2 0 .5
        assert got == pytest.approx(0.2 * 1.0 + 0.2 * 0.7 + 0.5 * 0.3)


def test_average_precision_hit_and_miss():
    gt = [np.array([[0, 0.5, 0.5, 0.2, 0.2]], np.float32)]
    hit = [np.array([[0.5, 0.5, 0.2, 0.2, 0.9, 0.9, 0]], np.float32)]
    miss = [np.array([[0.1, 0.1, 0.2, 0.2, 0.9, 0.9, 0]], np.float32)]
    assert PE.average_precision(hit, gt) == pytest.approx(1.0)
    assert PE.average_precision(miss, gt) == 0.0


@pytest.mark.parametrize("num_classes", [15, 7, 1])
def test_class_color_equals_jax(num_classes):
    assert [PE.class_color(c, num_classes) for c in range(num_classes)] == [
        JE.class_color(c, num_classes) for c in range(num_classes)]


def test_draw_detections_same_bytes(tmp_path):
    rng = np.random.default_rng(9)
    base = (rng.random((96, 96, 3)) * 255).astype(np.uint8)
    dets = np.array([[0.5, 0.5, 0.3, 0.2, 0.9, 0.8, 3],
                     [0.2, 0.7, 0.1, 0.1, 0.6, 0.5, 14],
                     [np.inf, 0.5, 0.1, 0.1, 0.9, 0.9, 1],   # skipped
                     [0.9, 0.1, 3.0, 0.2, 0.5, 0.5, 0]], np.float32)
    names = [f"c{i}" for i in range(15)]
    outs = []
    for mod, name in ((PE, "port.png"), (JE, "jax.png")):
        img = Image.fromarray(base.copy())
        got = mod.draw_detections(img, dets, names, str(tmp_path / name))
        buf = io.BytesIO()
        got.save(buf, format="PNG")
        outs.append((np.asarray(got), (tmp_path / name).read_bytes(),
                     buf.getvalue()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1] and outs[0][2] == outs[1][2]
    assert not np.array_equal(outs[0][0], base)


@pytest.mark.parametrize("class_id", [None, 0, 3])
def test_average_precision_tied_scores_equal_jax(class_id):
    """Scores tied across images and rows (rounded to one decimal): the
    ranking keeps image and row order on ties, as the JAX function's
    stable sort does."""
    rng = np.random.default_rng(21)
    preds, gts = [], []
    for _ in range(8):
        n = int(rng.integers(0, 40))
        p = np.zeros((n, 7), np.float32)
        p[:, 0:2] = rng.uniform(0.1, 0.9, (n, 2))
        p[:, 2:4] = rng.uniform(0.05, 0.3, (n, 2))
        p[:, 4:6] = np.round(rng.uniform(0.2, 1.0, (n, 2)), 1)
        p[:, 6] = rng.integers(0, 4, n)
        preds.append(p)
        k = int(rng.integers(0, 6))
        g = np.concatenate([rng.integers(0, 4, (k, 1)),
                            p[:k, 0:4] if n >= k else
                            rng.uniform(0.1, 0.9, (k, 4))], 1)
        gts.append(g.astype(np.float32))
    got = PE.average_precision(preds, gts, 0.5, class_id)
    assert got == JE.average_precision(preds, gts, 0.5, class_id)
    assert PE.mean_average_precision(preds, gts, 4) == \
        JE.mean_average_precision(preds, gts, 4)
