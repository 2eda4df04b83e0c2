"""The comparison that decides ``correct`` fails where it should: the
control (the plain reference in the program's place, in float8) and
each fault a training cell can have, planted under the timed path of a
whole run that skips only the look for a card. At a tiny size on the
CPU, with the tiny configuration's limits (``conftest.TINY_CONFIG``),
which name the numbers the real cells compare."""

import json
import os

import pytest

from benchmark import calibrate, run

from .conftest import ROOT, TINY_CONFIG


def _run(root, faults=(), seed=1):
    with open(os.devnull, "w") as out:
        return run.run_cell(root, "tiny-train", seed, 2.0, False,
                            device="cpu", faults=faults, out=out)


def test_sound_run_is_correct(tiny_root):
    res = _run(tiny_root)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "compared"
    assert res["metrics"]["train_img_per_s.tiny"]["value"] > 0


def test_control_fails(tiny_root):
    _, ctl = calibrate.readings(tiny_root, "tiny-train", 1, 2.0, "fp8",
                                device="cpu")
    limits = TINY_CONFIG["limits"]["patch_train"]
    assert any(ctl[k] > v for k, v in limits.items()), ctl


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_fails(tiny_root, fault):
    res = _run(tiny_root, faults=(fault,))
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("config", ["yolov3-dota-608", "yolov3-coco-416"])
def test_real_cells_compare_the_tiny_numbers(config):
    """The tiny configuration's limits name the numbers the real cells
    compare, so the tests above exercise the real comparison."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           config + ".json")) as f:
        limits = json.load(f)["limits"]["patch_train"]
    assert set(limits) == set(TINY_CONFIG["limits"]["patch_train"])
