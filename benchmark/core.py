"""What every run shares: the cell's files found by name, the card check,
sub-seeds, the JAX check, the result line.

A cell names a configuration (``configs`` entry of ``BENCHMARK.json``:
its ``file``, which names its victim's darknet cfg, ``cfgfile``, beside
it), a traffic mix (``benchmark/traffic/<traffic>.json``,
which names its ``loop``: ``benchmark/loops/<loop>.py``) and, by the
metrics' ``workloads``, its per-layer metrics
(``benchmark/metrics/<metric>.py``). Each is looked up under the checkout
first and then beside this file, so a new cell, mix or metric is a new
file and an entry, with no edit to a file already there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .reference import cfg

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
PORT = ("adversarial_patch_based_false_positive_creation_attacks_against_"
        "aerial_imagery_object_detectors_tpu_torch")
# compared by whole top-level module name: the port's name begins with
# the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", PORT[:-len("_torch")])


def derive(seed: int, k: int) -> int:
    """The ``k``-th sub-seed of a run's seed, a non-negative 63-bit int."""
    return (int(seed) * 0x9E3779B97F4A7C15 + k * 0xBF58476D1CE4E5B9) % 2 ** 63


def forbidden_modules(modules=None) -> List[str]:
    mods = sys.modules if modules is None else modules
    return sorted({m for m in mods if m.split(".")[0] in FORBIDDEN})


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def read_config(path: str) -> dict:
    """A configuration file, with the text of the darknet cfg it names
    (``cfgfile``, a path beside it) under ``cfg_text``: the program and
    the reference build the victim from these same bytes. Raises where
    the cfg's input size, classes or head filters disagree with the
    file's."""
    with open(path) as f:
        config = json.load(f)
    with open(os.path.join(os.path.dirname(path), config["cfgfile"])) as f:
        config["cfg_text"] = f.read()
    cfg.check(config, *cfg.parse(config["cfg_text"]))
    return config


class Bench:
    """``BENCHMARK.json`` of a checkout and the files its names point
    at."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return read_config(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def find(self, kind: str, name: str, ext: str) -> str:
        for base in (os.path.join(self.root, "benchmark"), PKG_DIR):
            path = os.path.join(base, kind, name + ext)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no {kind}/{name}{ext}")

    def traffic(self, name: str) -> dict:
        with open(self.find("traffic", name, ".json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        path = self.find(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


@dataclass
class Env:
    """One run: the cell's entries and what the command line gave."""
    bench: Bench
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    faults: Sequence[str] = ()


@dataclass
class WindowResult:
    """What a loop's window measured: the end-to-end values by name,
    the work attempted and failed, and host counters for the
    per-layer readers."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    host: Dict[str, float] = field(default_factory=dict)


@dataclass
class Reading:
    """What a per-layer reader is handed."""
    env: Env
    window: WindowResult
    trace: Optional[object]
    device_name: str

