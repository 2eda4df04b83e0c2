"""The port's eval CLIs end to end on the CPU (``--device cpu``), on the
mini victim (``tests/fixtures/refparity``, 320^2, trained) over its three
tiles: ``images_filter`` -> ``clean_img_pre`` (also class-filtered) ->
``test_patch`` -> ``test_patch_metrics --json``, ``paste_patch`` in both
modes and ``dataset_tools`` (the scenarios of ``tests/test_cli.py``).
``test_patch`` is held against the JAX package's functions on the same
patch, seed, labels and weights: equal placements for every tile, and
the first tile's detections equal up to greedy-NMS tie order (1e-3, the
structural check of ``tests/test_refparity.py``). ``paste_patch
--fixed-center`` is held against the JAX package's CLI within one uint8
level."""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "refparity")
CFG = os.path.join(FIX, "mini_yolov3_dota.cfg")
WEIGHTS = os.path.join(FIX, "mini_yolov3_dota.weights")
MODEL = ["--cfgfile", CFG, "--weightfile", WEIGHTS, "--img-size", "320",
         "--fp32", "--device", "cpu"]
PATCH = 64

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import attack as JA  # noqa: E402
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import evals as JE  # noqa: E402
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import models as JM  # noqa: E402
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.data import dataset as JD  # noqa: E402
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import attack as PA  # noqa: E402
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.cli import (  # noqa: E402
    clean_img_pre, dataset_tools, images_filter, paste_patch, test_patch,
    test_patch_metrics)
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.data.labels import read_label_file  # noqa: E402
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.utils.checkpoint import load_patch_png  # noqa: E402


def structural_match(ours, ref, nms_thresh, atol=1e-3):
    """Equal up to greedy-NMS tie order: counts within max(2, 1.5%), at
    most 3% of ``ref`` unmatched 1-1 within ``atol``, and every unmatched
    reference row overlapping (IoU > nms_thresh) one of our unmatched
    rows (another representative of the same suppression cluster)."""
    ours = np.asarray(ours, np.float32).reshape(-1, 7)
    ref = np.asarray(ref, np.float32).reshape(-1, 7)
    assert abs(len(ours) - len(ref)) <= max(2, 0.015 * len(ref))
    used = np.zeros(len(ref), bool)
    mine = np.zeros(len(ours), bool)
    for i, row in enumerate(ours):
        d = np.abs(ref - row).max(axis=1)
        d[used] = np.inf
        j = int(np.argmin(d))
        if d[j] <= atol:
            used[j] = mine[i] = True
    assert (~used).sum() <= 0.03 * len(ref), ((~used).sum(), len(ref))
    alt = ours[~mine]
    for r in ref[~used]:
        x1, y1 = alt[:, 0] - alt[:, 2] / 2, alt[:, 1] - alt[:, 3] / 2
        x2, y2 = alt[:, 0] + alt[:, 2] / 2, alt[:, 1] + alt[:, 3] / 2
        iw = np.clip(np.minimum(r[0] + r[2] / 2, x2)
                     - np.maximum(r[0] - r[2] / 2, x1), 0, None)
        ih = np.clip(np.minimum(r[1] + r[3] / 2, y2)
                     - np.maximum(r[1] - r[3] / 2, y1), 0, None)
        inter = iw * ih
        iou = inter / (r[2] * r[3] + alt[:, 2] * alt[:, 3] - inter + 1e-12)
        assert len(alt) and iou.max() > nms_thresh, r
    return int(used.sum())


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Raw tiles, a seeded patch PNG, and the pipeline's directories."""
    root = tmp_path_factory.mktemp("eval_cli")
    raw = root / "raw"
    raw.mkdir()
    for i in range(3):
        Image.open(os.path.join(FIX, f"tile_{i}.png")).save(
            raw / f"tile_{i}.png")
    rng = np.random.default_rng(3)
    Image.fromarray((rng.random((PATCH, PATCH, 3)) * 255).astype(
        np.uint8)).save(root / "patch.png")
    return root


@pytest.fixture(scope="module")
def pipeline(work):
    """images_filter -> test_patch -> test_patch_metrics on the port,
    with the placements ``test_patch`` made."""
    gt = str(work / "gt")
    images_filter.main([*MODEL, "--img-dir", str(work / "raw"),
                        "--out-dir", gt, "--conf", "0.01",
                        "--batch-size", "2"])
    placements = []
    real = PA.transform_patch_eval

    def recorded(*a, **kw):
        adv, centre = real(*a, **kw)
        placements.append(centre)
        return adv, centre
    PA.transform_patch_eval = recorded
    try:
        test_patch.main([*MODEL, "--patch", str(work / "patch.png"),
                         "--patch-size", str(PATCH), "--img-dir",
                         os.path.join(gt, "images"), "--lab-dir",
                         os.path.join(gt, "yolo-labels_w_conf"),
                         "--out-dir", str(work / "attacked"), "--conf",
                         "0.01", "--seed", "5", "--save-images"])
    finally:
        PA.transform_patch_eval = real
    return gt, str(work / "attacked"), placements


def test_images_filter_layout(pipeline):
    gt, _, _ = pipeline
    kept = sorted(os.listdir(os.path.join(gt, "images")))
    assert kept == [f"tile_{i}.png" for i in range(3)]
    for sub, ncols in (("yolo-labels_w_conf", 7), ("yolo-labels", 5)):
        names = sorted(os.listdir(os.path.join(gt, sub)))
        assert names == [k.replace(".png", ".txt") for k in kept]
        for n in names:
            rows = read_label_file(os.path.join(gt, sub, n), None)
            assert rows.shape[1] == ncols or len(rows) == 0
    rows = read_label_file(os.path.join(gt, "yolo-labels_w_conf",
                                        "tile_0.txt"), 7)
    strong = read_label_file(os.path.join(gt, "yolo-labels", "tile_0.txt"))
    assert len(strong) == int((rows[:, 4] > 0.4).sum()) > 0


def test_clean_img_pre_plain_and_class_filtered(work):
    out = str(work / "clean")
    clean_img_pre.main([*MODEL, "--img-dir", str(work / "raw"),
                        "--out-dir", out, "--conf", "0.2", "--save-images",
                        "--batch-size", "2"])
    assert len(os.listdir(os.path.join(out, "yolo-labels"))) == 3
    assert len(os.listdir(os.path.join(out, "images"))) == 3
    cf = str(work / "clean_cf")
    clean_img_pre.main([*MODEL, "--img-dir", str(work / "raw"),
                        "--out-dir", cf, "--conf", "0.2", "--batch-size",
                        "2", "--class-filter", "5", "--min-box-size", "0.1"])
    files = os.listdir(os.path.join(cf, "yolo-labels"))
    assert len(files) == 3
    for f in files:
        rows = read_label_file(os.path.join(cf, "yolo-labels", f), 7)
        assert (rows[:, 6] == 5).all()
        assert (rows[:, 2] >= 0.1).all() and (rows[:, 3] >= 0.1).all()


def test_test_patch_matches_jax(pipeline, work):
    """The JAX package's eval loop on the same patch, labels, seed and
    weights: every tile's placement equal; tile 0's detections equal up
    to NMS tie order."""
    gt, attacked, placements = pipeline
    net = JM.network_from_cfg(CFG)
    params, _ = JM.load_darknet_weights(net, WEIGHTS)
    det = JE.Detector(net, JM.fold_bn(net, params), img_size=320,
                      num_classes=15, compute_dtype=jnp.float32)
    patch = jnp.asarray(load_patch_png(str(work / "patch.png"), PATCH))
    rng = np.random.default_rng(5)
    cfg = JA.EvalEOTConfig(img_size=320)
    names = sorted(os.listdir(os.path.join(gt, "images")))
    assert len(placements) == len(names)
    for i, name in enumerate(names):
        stem = name[:-4]
        labels = read_label_file(
            os.path.join(gt, "yolo-labels_w_conf", stem + ".txt"), 7)
        adv, centre = JA.transform_patch_eval(patch, labels, rng, cfg)
        assert placements[i] == centre, (name, placements[i], centre)
        if i == 0:
            arr, _ = JD.pad_and_scale(
                JD.load_image_rgb(os.path.join(gt, "images", name)),
                np.zeros((0, 5), np.float32), 320)
            patched = np.asarray(JA.paste_patch(
                jnp.asarray(arr)[None], jnp.asarray(adv)[None]))[0]
            want = det.detect(patched, 0.01, 0.4)
            ours = read_label_file(
                os.path.join(attacked, "yolo-labels_w_conf", stem + ".txt"),
                7)
            assert structural_match(ours, want, 0.4) > 0.95 * len(want)
    for sub in ("yolo-labels_w_conf", "yolo-labels", "images"):
        assert len(os.listdir(os.path.join(attacked, sub))) == len(names)


def test_metrics_json(pipeline, capsys):
    gt, attacked, _ = pipeline
    report = test_patch_metrics.main(["--pred-dir", attacked, "--gt-dir", gt,
                                      "--json"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(report)
    assert len(report["M4_per_class_gap_001"]) == 15
    for k, v in report.items():
        if k == "M4_per_class_gap_001":
            continue
        assert np.isfinite(v) or k.startswith("M2"), (k, v)
    want = JE.creation_metrics_report(
        os.path.join(attacked, "yolo-labels"), os.path.join(gt, "yolo-labels"),
        os.path.join(attacked, "yolo-labels_w_conf"),
        os.path.join(gt, "yolo-labels_w_conf"), 3)
    for k, v in want.items():
        assert report[k] == v or (np.isnan(v) and np.isnan(report[k])), k
    assert report["mAP"] == JE.mean_average_precision(
        os.path.join(attacked, "yolo-labels_w_conf"),
        os.path.join(gt, "yolo-labels"), 15, 0.5)


def test_paste_patch_fixed_matches_jax_cli_and_eot(work, tmp_path):
    sys.path.insert(0, os.path.join(REPO, "cli"))
    try:
        import paste_patch as jax_paste_patch
    finally:
        sys.path.pop(0)
    common = ["--patch", str(work / "patch.png"), "--patch-size", str(PATCH),
              "--img-dir", str(work / "raw"), "--img-size", "320",
              "--fixed-center", "0.5", "0.5", "--fixed-scale", "0.4"]
    paste_patch.main([*common, "--out-dir", str(tmp_path / "port"),
                      "--device", "cpu"])
    jax_paste_patch.main([*common, "--out-dir", str(tmp_path / "jax")])
    for i in range(3):
        name = f"tile_{i}.png"
        got = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        want = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        src = np.asarray(Image.open(work / "raw" / name), np.int16)
        assert np.abs(got - want).max() <= 1
        # borders untouched, centre changed
        np.testing.assert_array_equal(got[:40], src[:40])
        np.testing.assert_array_equal(got[:, -40:], src[:, -40:])
        assert not np.array_equal(got[150:170, 150:170],
                                  src[150:170, 150:170])

    labs = tmp_path / "labs"
    labs.mkdir()
    for i in range(3):
        (labs / f"tile_{i}.txt").write_text("2 0.5 0.5 0.4 0.4\n")
    eot = [*common[:8], "--lab-dir", str(labs), "--seed", "7",
           "--device", "cpu"]
    paste_patch.main([*eot, "--out-dir", str(tmp_path / "eot")])
    paste_patch.main([*eot, "--out-dir", str(tmp_path / "eot2")])
    for i in range(3):
        name = f"tile_{i}.png"
        out = np.asarray(Image.open(tmp_path / "eot" / name), np.int16)
        src = np.asarray(Image.open(work / "raw" / name), np.int16)
        assert not np.array_equal(out, src)
        np.testing.assert_array_equal(
            out, np.asarray(Image.open(tmp_path / "eot2" / name), np.int16))


def test_dataset_tools(pipeline, work, tmp_path, capsys):
    """``list-files``, ``stats`` (5- and 7-column dirs) and ``recall``
    print what the JAX package's CLI prints on the same dirs (``stats``
    on 5-column files reads the class from the height column, as the
    reference does)."""
    gt, attacked, _ = pipeline
    sys.path.insert(0, os.path.join(REPO, "cli"))
    try:
        import dataset_tools as jax_dataset_tools
    finally:
        sys.path.pop(0)
    out = tmp_path / "list.txt"
    dataset_tools.main(["list-files", "--img-dir", str(work / "raw"),
                        "--out", str(out)])
    assert len(out.read_text().splitlines()) == 3
    capsys.readouterr()
    for argv in (["stats", "--img-dir", os.path.join(gt, "images"),
                  "--lab-dir", os.path.join(gt, "yolo-labels")],
                 ["stats", "--img-dir", os.path.join(gt, "images"),
                  "--lab-dir", os.path.join(gt, "yolo-labels_w_conf"),
                  "--ncols", "7"],
                 ["recall", "--pred-dir",
                  os.path.join(attacked, "yolo-labels_w_conf"),
                  "--gt-dir", os.path.join(gt, "yolo-labels")]):
        dataset_tools.main(argv)
        got = capsys.readouterr().out
        jax_dataset_tools.main(argv)
        assert got == capsys.readouterr().out
        assert got.strip()
    p, r = JE.precision_recall(os.path.join(attacked, "yolo-labels_w_conf"),
                               os.path.join(gt, "yolo-labels"), 0.4, 0.5)
    assert f"precision {p:.4f}  recall {r:.4f}" in got
