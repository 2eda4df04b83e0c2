"""The port's ``utils/profiling.py`` on the CPU, as the JAX package's
``tests/test_utils.py::test_step_timer`` and
``::test_trace_noop_and_annotate`` hold its own, and the trace written to
a directory."""

import glob
import json
import os

import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import utils
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.utils import profiling
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.utils.profiling import (
    StepTimer, annotate, trace)


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
