"""The port's ``utils/profiling.py`` on the CPU, as the JAX package's
``tests/test_utils.py::test_step_timer`` and
``::test_trace_noop_and_annotate`` hold its own, the trace written to
a directory, and the training step's spans: none with no profiler on, the
tree of ``train.*`` records and regions under one, and the same patch
either way."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import utils
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.data.labels import pad_labels
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.train import config as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.train import trainer as PT
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.utils import profiling
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.utils.profiling import (
    StepTimer, annotate, span, span_records, trace)

# one step's records, in the order they open, with their parents
STEP_TREE = [("train.step", None), ("train.inputs", "train.step"),
             ("train.eot", "train.step"), ("train.victim_fwd", "train.step"),
             ("train.loss", "train.step"), ("train.backward", "train.step"),
             ("train.victim_bwd", "train.backward"),
             ("train.eot_bwd", "train.backward"),
             ("train.update", "train.step")]
# the regions in the trace: the backward's split lives in the records
TRACED = [n for n, _ in STEP_TREE
          if n not in ("train.victim_bwd", "train.eot_bwd")]


def test_step_timer():
    t = StepTimer(report_every=3)
    x = torch.ones(4)
    rates = [t.tick(x) for _ in range(7)]
    assert rates[0] is None and rates[1] is None
    # the first report boundary (tick 3) has no interval yet; the second
    # (tick 6) has one
    assert rates[2] is None
    assert rates[5] is not None and rates[5] > 0
    assert rates[6] is None and t.count == 7


def test_trace_noop_and_annotate(tmp_path):
    with trace(None) as prof:          # disabled: no-op
        assert prof is None
        with annotate("region"):
            _ = torch.ones(3) + 1
    with trace(""):
        pass
    assert os.listdir(tmp_path) == []
    assert utils.trace is trace and utils.annotate is annotate
    assert utils.StepTimer is StepTimer


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """``trace(dir)`` profiles the block and writes one Chrome trace into
    the directory when it ends; an ``annotate`` region is in it by name."""
    with trace(str(tmp_path)) as prof:
        assert prof is not None
        with annotate("apfp_region"):
            torch.mm(torch.ones(32, 32), torch.ones(32, 32))
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1, os.listdir(tmp_path)
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "apfp_region" in names
    assert any(str(n).startswith("aten::mm") for n in names)


def test_trace_refuses_a_host_only_trace_beside_a_card(tmp_path,
                                                       monkeypatch):
    """With a card visible, a PyTorch that cannot trace its activity makes
    ``trace(dir)`` raise instead of writing a trace without the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiling, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="card"):
        with trace(str(tmp_path)):
            raise AssertionError("the block ran")
    assert os.listdir(tmp_path) == []


def _exp():
    return PC.ExperimentConfig(name="tiny", img_size=64, patch_size=16,
                               batch_size=4, max_labels=8,
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def victim():
    net = PM.build_network(PM.tiny_test_blocks())
    params = PM.fold_bn(net, PM.init_params(net, 3))
    return net, params


def _store(n=6, seed=0):
    """A uint8 device store of ``n`` tiles, each with one box."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, (n, 64, 64, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(np.stack([pad_labels(np.array(
        [[i % 15, 0.5, 0.5, 0.3, 0.3]], np.float32), 8) for i in range(n)]))
    return images, labels


def _epoch(victim, steps=2, seed=5):
    """The patch after one ``epoch_fn`` call of ``steps`` steps."""
    net, params = victim
    exp = _exp()
    model = PM.Darknet(net, params, torch.float32, device="cpu").eval()
    gen = torch.Generator().manual_seed(seed)
    patch = PT.init_patch(exp, gen).requires_grad_(True)
    opt = PT.make_optimizer(patch, exp.learning_rate)
    images, labels = _store()
    idx = torch.arange(steps * 4).reshape(steps, 4) % images.shape[0]
    with torch.enable_grad():
        PT.make_epoch_scan_fn(model, exp)(
            patch, opt, gen, images, labels, idx, torch.ones(steps, 4),
            exp.learning_rate)
    return patch.detach().clone()


def _per_step(victim, steps=2):
    net, params = victim
    tr = PT.PatchTrainer(_exp(), net, params, seed=5, device="cpu",
                         log=lambda s: None)
    images, labels = _store()
    for k in range(steps):
        rows = (np.arange(4) + 4 * k) % images.shape[0]
        with torch.enable_grad():
            tr.step(images[rows].float().numpy() / 255.0,
                    labels[rows].numpy())
    return tr.patch.detach().clone()


def test_span_off_records_nothing_and_enters_nothing(victim, monkeypatch):
    """With no profiler on, a training step enters no ``record_function``,
    registers no tensor hook, and leaves the records as they were; every
    span is the one shared no-op."""
    before = span_records()

    def refuse(*a, **k):
        raise AssertionError("entered with no profiler on")
    monkeypatch.setattr(profiling, "record_function", refuse)
    hooks = []
    register = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda t, fn: hooks.append(fn) or register(t, fn))
    assert not profiling.recording()
    assert span("a") is span("b", split=("c", "d"))
    _epoch(victim)
    _per_step(victim, steps=1)
    assert hooks == []
    assert span_records() == before


@pytest.mark.parametrize("path", ["epoch", "per_step"])
def test_span_tree_under_the_profiler(victim, path):
    """Under ``torch.profiler.profile`` each step records the tree, in
    order, its spans sharing the step's ordinal; the backward's two parts
    tile it, the victim's input backward first; each child lies inside
    its parent; no card, so no device time."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        (_epoch if path == "epoch" else _per_step)(victim, steps=2)
    recs = span_records()
    assert [(r["name"], r["parent"]) for r in recs] == STEP_TREE * 2
    assert [r["step"] for r in recs] == [1] * 9 + [2] * 9
    for step in (recs[:9], recs[9:]):
        by = {r["name"]: r for r in step}
        bwd, vb, eb = (by["train.backward"], by["train.victim_bwd"],
                       by["train.eot_bwd"])
        assert vb["host_start"] == bwd["host_start"]
        assert vb["host_end"] == eb["host_start"]
        assert eb["host_end"] == bwd["host_end"]
        assert vb["host_start"] < vb["host_end"] < eb["host_end"]
        for r in step:
            assert r["device_ms"] is None
            assert r["host_ms"] == pytest.approx(
                1e3 * (r["host_end"] - r["host_start"]))
            if r["parent"] is not None:
                p = by[r["parent"]]
                assert p["host_start"] <= r["host_start"]
                assert r["host_end"] <= p["host_end"]
        opened = [by[n]["host_start"] for n, _ in STEP_TREE
                  if n not in ("train.victim_bwd", "train.eot_bwd")]
        assert opened == sorted(opened)


def test_trace_dir_holds_the_step_regions(victim, tmp_path):
    """The Chrome trace that ``trace(dir)`` writes around training holds
    every ``train.*`` region by name, twice for two steps; the backward
    is one region there."""
    with trace(str(tmp_path)):
        _epoch(victim, steps=2)
    (path,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and str(e.get("name")).startswith("train.")]
    assert sorted(set(names)) == sorted(TRACED)
    assert all(names.count(n) == 2 for n in TRACED)
    assert [r["name"] for r in span_records()] == [n for n, _ in STEP_TREE] * 2


def test_patch_equal_with_and_without_the_profiler(victim):
    """Three steps give the same patch, bit for bit, with the spans and
    the backward's hook recording and with neither."""
    off = _epoch(victim, steps=3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = _epoch(victim, steps=3)
    assert len(span_records()) == 27
    assert torch.equal(on, off)
    assert not torch.equal(off, _epoch(victim, steps=3, seed=6))


def test_records_clear_when_the_profiler_turns_on_and_stop_at_the_cap(
        monkeypatch):
    """A profiler session starts with no record (the records read again
    are the same until then); past ``MAX_SPANS`` spans still run but are
    not kept; a ``cut`` outside a split span, or with no profiler on,
    changes nothing."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with span("outer"):
            with span("inner"):
                profiling.cut()
    first = span_records()
    assert [(r["name"], r["parent"], r["step"]) for r in first] \
        == [("outer", None, 1), ("inner", "outer", 1)]
    profiling.cut()
    assert span_records() == first
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with torch.profiler.profile(activities=acts):
        for _ in range(2):
            with span("a", split=("a0", "a1")):
                profiling.cut()
    assert [(r["name"], r["parent"], r["step"]) for r in span_records()] \
        == [("a", None, 1), ("a0", "a", 1), ("a1", "a", 1)]
