"""The benchmark's tests run on the CPU at a tiny size; those that need a
card are marked ``gpu`` and skip here."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIG = {
    "name": "tiny", "cfgfile": "tiny.cfg", "architecture": "tiny",
    "img_size": 64,
    "num_classes": 15, "head_filters": 60,
    "anchors": "15, 31,  19, 12,  28, 40,  40, 20,  43, 38,  42, 87,  "
               "78, 54,  95, 102,  181, 206",
    "decode_anchors": [[15, 31], [19, 12], [28, 40], [40, 20], [43, 38],
                       [42, 87], [78, 54], [95, 102], [181, 206]],
    "patch_size": 16, "target_id": 14,
    # the program's own readings on the CPU at this size (bfloat16) lie
    # far below these, and the float8 control and each planted fault far
    # above (test_bench_control.py): composite 0.0020-0.0021 against
    # 0.033-0.042, heads 0.015-0.018 against 0.28-0.34, a row's class
    # gradient norm 0.005-0.010 against 0.089-0.19 (half the batch
    # 1.00-1.02), the change 0.0001-0.0023 against 1 (the state left
    # unchanged)
    "limits": {
        "patch_train": {"composite_gap": 0.01, "heads_gap": 0.08,
                        "cls_grad_row_gap": 0.04, "change_norm_gap": 0.05},
    },
}


def cfg_text(name: str) -> str:
    """The text of a cfg file kept beside these tests."""
    with open(os.path.join(HERE, name)) as f:
        return f.read()


# the tiny configuration as ``core.read_config`` hands it on
TINY = dict(TINY_CONFIG, cfg_text=cfg_text("tiny.cfg"))
TINY_TRAIN = {"loop": "patch_train", "experiment": "paper_obj",
              "batch": 8, "store_tiles": 40, "max_labels": 12,
              "label_tail": 1.0, "steps_per_call": 2, "trace_seconds": 0.5}


def write_root(root, metrics=()):
    """A checkout holding ``BENCHMARK.json`` with a tiny training cell,
    and its configuration (``tiny.json`` and its ``tiny.cfg``) and
    traffic files; loops and readers come from the benchmark itself."""
    bdir = os.path.join(root, "benchmark")
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(bdir, sub), exist_ok=True)
    with open(os.path.join(bdir, "configs", "tiny.json"), "w") as f:
        json.dump(TINY_CONFIG, f)
    shutil.copy(os.path.join(HERE, "tiny.cfg"), os.path.join(bdir, "configs"))
    with open(os.path.join(bdir, "traffic", "tiny-train.json"), "w") as f:
        json.dump(TINY_TRAIN, f)
    spec = {
        "command": ["python3", "-m", "benchmark.run"],
        "paths": ["benchmark"], "run_seconds": 1,
        "configs": [{"name": "tiny", "source": "tests",
                     "file": "benchmark/configs/tiny.json", "reduced": [],
                     "why": "tests"}],
        "workloads": [
            {"name": "tiny-train", "config": "tiny", "traffic": "tiny-train",
             "chips": 1, "why": "tests"}],
        "end_to_end": [
            # a qualified name reads the loop's train_img_per_s
            {"name": "train_img_per_s.tiny", "unit": "img/s",
             "better": "higher",
             "bound": 0.25, "source": "host_clock",
             "workloads": ["tiny-train"]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": list(metrics),
    }
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_root(str(tmp_path))
