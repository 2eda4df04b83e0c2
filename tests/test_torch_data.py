"""The port's training data (label files, the DOTA dataset, the batch
loader, the epoch plan and the synthetic tiles) against the JAX package's
numpy implementations: the same files and seeds give the same arrays,
bit for bit."""

import numpy as np
import pytest
from PIL import Image

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.data import dataset as JD
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.data import labels as JL
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.data import dataset as PD
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.data import labels as PL


@pytest.fixture
def tiles(tmp_path):
    """Five tiles of mixed shapes and formats, one with an empty label
    file; beside them a 7-column eval label file."""
    rng = np.random.default_rng(0)
    img_dir, lab_dir = tmp_path / "images", tmp_path / "labels"
    img_dir.mkdir()
    lab_dir.mkdir()
    shapes = [(40, 40), (30, 50), (50, 30), (64, 64), (20, 36)]
    for i, (h, w) in enumerate(shapes):
        ext = ".jpg" if i == 3 else ".png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            img_dir / f"t{i}{ext}")
        k = 0 if i == 1 else int(rng.integers(1, 5))
        rows = np.concatenate([rng.integers(0, 15, (k, 1)),
                               rng.uniform(0.1, 0.9, (k, 4))], axis=1)
        PL.write_label_file(str(lab_dir / f"t{i}.txt"), rows)
    PL.write_label_file(str(tmp_path / "eval.txt"), rng.uniform(0, 1, (3, 7)))
    return str(img_dir), str(lab_dir)


def test_label_functions_match(tiles):
    _, lab_dir = tiles
    rng = np.random.default_rng(1)
    for i in range(5):
        path = f"{lab_dir}/t{i}.txt"
        for ncols in (5, None):
            np.testing.assert_array_equal(PL.read_label_file(path, ncols),
                                          JL.read_label_file(path, ncols))
        lab = PL.read_label_file(path)
        np.testing.assert_array_equal(PL.pad_labels(lab, 8),
                                      JL.pad_labels(lab, 8))
    path = f"{lab_dir}/../eval.txt"
    for ncols in (7, None):
        np.testing.assert_array_equal(PL.read_label_file(path, ncols),
                                      JL.read_label_file(path, ncols))
    assert PL.count_instances(lab_dir) == JL.count_instances(lab_dir)
    boxes = rng.uniform(0, 0.2, (20, 7)).astype(np.float32)
    for scale in (0.05, 0.1):
        np.testing.assert_array_equal(PL.filter_min_box_scale(boxes, scale),
                                      JL.filter_min_box_scale(boxes, scale))


def test_dataset_and_loader_match(tiles):
    img_dir, lab_dir = tiles
    pds = PD.DotaDataset(img_dir, lab_dir, max_labels=6, img_size=32)
    jds = JD.DotaDataset(img_dir, lab_dir, max_labels=6, img_size=32)
    assert len(pds) == len(jds) == 5 and pds.names == jds.names
    for i in range(5):
        for a, b in zip(pds[i], jds[i]):
            np.testing.assert_array_equal(a, b)
    for drop_last in (False, True):
        pl = PD.BatchLoader(pds, 2, num_workers=2, seed=3,
                            drop_last=drop_last)
        jl = JD.BatchLoader(jds, 2, num_workers=2, seed=3,
                            drop_last=drop_last)
        assert len(pl) == len(jl) == (2 if drop_last else 3)
        for _ in range(2):      # two epochs: the shuffle stream continues
            got, want = list(pl), list(jl)
            assert len(got) == len(want)
            for (pi, plab), (ji, jlab) in zip(got, want):
                np.testing.assert_array_equal(pi, ji)
                np.testing.assert_array_equal(plab, jlab)


@pytest.mark.parametrize("n,bs,drop_last", [(10, 4, False), (10, 4, True),
                                            (8, 4, False), (3, 5, False)])
def test_epoch_plan_and_synthetic_data_match(n, bs, drop_last):
    for epoch in (0, 3):
        got = PD.epoch_plan(n, bs, epoch, seed=2, drop_last=drop_last)
        want = JD.epoch_plan(n, bs, epoch, seed=2, drop_last=drop_last)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(PD.SyntheticData(n, 16, 6, seed=1).batch(bs, 2),
                    JD.SyntheticData(n, 16, 6, seed=1).batch(bs, 2)):
        np.testing.assert_array_equal(a, b)
