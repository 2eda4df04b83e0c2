"""The parts of the program under test that the benchmark drives: its
entry points, its counters and its victim built from the benchmark's
weights. Nothing else of the benchmark imports the program."""

from __future__ import annotations

import importlib

import numpy as np

from .core import PORT


def mod(name: str):
    return importlib.import_module(f"{PORT}.{name}")


def network(config: dict):
    """The program's compiled network for a configuration file: its own
    parser over the cfg text the configuration carries."""
    return mod("models.darknet").network_from_cfg(config["cfg_text"])


def params(weights: dict) -> dict:
    """The benchmark's folded weights in the program's params layout."""
    return {f"conv_{i}": {"w": w, "b": b} for i, (w, b) in weights.items()}


def decode_anchors(config: dict) -> np.ndarray:
    """[3, 3, 2] anchors (w, h) in head order, as the configuration
    pairs them with the heads at decode."""
    return np.asarray(config["decode_anchors"], np.float64).reshape(3, 3, 2)


def kernel_launches(reset: bool = False) -> dict:
    return mod("ops").kernel_launches(reset)
