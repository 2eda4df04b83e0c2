"""The readers of the program's own spans (``benchmark/spans.py``): their
sums and per-step division on synthetic records, a traced tiny run on the
CPU through ``run_cell`` (host metrics read, device metrics left out),
and each cell's traced run on the card (``-m gpu``)."""

import json
import math
import os
import subprocess

import pytest

from benchmark import run, spans

from .conftest import ROOT, write_root

# the metrics that read the spans, by cell
NEW = {
    "dota608-train-b24": ["eot_ms_per_step.train",
                          "victim_fwd_ms_per_step.train",
                          "victim_bwd_ms_per_step.train",
                          "loss_update_ms_per_step.train"],
    "coco416-train-b24": ["eot_ms_per_step.coco416",
                          "victim_fwd_ms_per_step.coco416",
                          "victim_bwd_ms_per_step.coco416",
                          "loss_update_ms_per_step.coco416",
                          "eot_host_ms_per_step.coco416",
                          "victim_host_ms_per_step.coco416",
                          "loss_update_host_ms_per_step.coco416"],
}


def _rec(name, host, device):
    return {"name": name, "host_ms": host, "device_ms": device}


def test_per_step_sums_over_steps():
    recs = []
    for k in range(3):
        recs += [_rec("train.step", 100.0, 97.0),
                 _rec("train.inputs", 1.0, 0.5),
                 _rec("train.eot", 10.0 + k, 30.0),
                 _rec("train.victim_fwd", 20.0, 25.0),
                 _rec("train.loss", 2.0, 1.0),
                 _rec("train.backward", 60.0, 40.0),
                 _rec("train.victim_bwd", 40.0, 28.0),
                 _rec("train.eot_bwd", 20.0, 12.0),
                 _rec("train.update", 3.0, 0.5)]
    assert spans.per_step(recs, spans.EOT, "device_ms") == pytest.approx(42.0)
    assert spans.per_step(recs, spans.EOT, "host_ms") == pytest.approx(31.0)
    assert spans.per_step(recs, spans.VICTIM_BWD, "device_ms") == 28.0
    assert spans.per_step(recs, spans.REST, "device_ms") == pytest.approx(2.0)
    parts = [spans.per_step(recs, n, "device_ms") for n in
             (spans.EOT, spans.VICTIM_FWD, spans.VICTIM_BWD, spans.REST)]
    assert sum(parts) == pytest.approx(spans.per_step(recs, ["train.step"],
                                                      "device_ms"))


@pytest.mark.parametrize("recs", [
    None, [],
    # no step record
    [_rec("train.eot", 1.0, 1.0)],
    # no record of the names
    [_rec("train.step", 1.0, 1.0)],
    # no card: no device time
    [_rec("train.step", 1.0, None), _rec("train.eot", 1.0, None)]])
def test_per_step_none_without_records(recs):
    assert spans.per_step(recs, spans.EOT, "device_ms") is None


def test_readers_none_without_span_records(monkeypatch):
    """A program without ``span_records`` (the parent of the spans): every
    reader returns None and raises nothing."""
    from benchmark import port
    monkeypatch.setattr(port, "mod", lambda name: object())
    assert spans.records() is None
    for read in (spans.eot_ms, spans.victim_fwd_ms, spans.victim_bwd_ms,
                 spans.loss_update_ms, spans.eot_host_ms,
                 spans.victim_host_ms, spans.loss_update_host_ms):
        assert read(None) is None


def test_traced_cpu_run_reads_the_host_spans(tmp_path):
    """A traced tiny run on the CPU reads the host metrics from the
    program's spans (positive, finite) and leaves the device metrics out:
    there is no card for their events."""
    names = NEW["coco416-train-b24"]
    metrics = [{"name": n, "unit": "ms", "better": "lower",
                "source": "host_clock", "layer": "tests",
                "moves": "train_img_per_s.tiny", "workloads": ["tiny-train"]}
               for n in names]
    root = write_root(str(tmp_path), metrics)
    os.makedirs(os.path.join(root, "benchmark", "metrics"))
    for n in names:
        with open(os.path.join(ROOT, "benchmark", "metrics",
                               n + ".py")) as f, \
                open(os.path.join(root, "benchmark", "metrics",
                                  n + ".py"), "w") as g:
            g.write(f.read())
    with open(os.devnull, "w") as out:
        res = run.run_cell(root, "tiny-train", 11, 2.0, True, device="cpu",
                           out=out)
    assert res["correct"]
    host = [n for n in names if "_host_" in n]
    assert sorted(res["metrics"]) == sorted(host)
    for n in host:
        v = res["metrics"][n]["value"]
        assert math.isfinite(v) and v > 0, (n, v)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(NEW))
def test_cell_traced_on_the_card_reads_the_spans(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    p = subprocess.run(spec["command"] + ["--workload", cell, "--seed",
                                          "3141592653", "--seconds", "8",
                                          "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["compared"]
    for n in NEW[cell]:
        v = res["metrics"][n]["value"]
        assert math.isfinite(v) and v > 0, (n, v)
