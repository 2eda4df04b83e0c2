"""One short run of each cell on the card (``-m gpu``); skips where
there is none."""

import json
import os
import subprocess

import pytest

from .conftest import ROOT


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", _cells())
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    p = subprocess.run(spec["command"] + ["--workload", cell, "--seed",
                                          "2718281828", "--seconds", "4",
                                          "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
