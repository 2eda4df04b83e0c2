"""YOLO label-file I/O (the JAX package's ``data/labels.py``).

Two formats flow through the pipeline: 5-col train labels
``cls x y w h`` (normalized) and 7-col eval labels
``x y w h obj cls_conf cls_id``. Empty label files map to the all-ones
sentinel row; training labels are padded to ``max_labels`` rows with
1e-6 (both reference quirks that the EOT relies on).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

EMPTY_SENTINEL = 1.0
PAD_VALUE = 1e-6


def read_label_file(path: str, ncols: Optional[int] = 5) -> np.ndarray:
    """Read a whitespace-separated label file -> [N, ncols] float32.
    ``ncols=None`` infers the column count from the first line. Missing
    or empty file -> [0, ncols or 5]."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return np.zeros((0, ncols or 5), dtype=np.float32)
    if ncols is None:
        with open(path) as f:
            ncols = max(len(f.readline().split()), 1)
    arr = np.loadtxt(path, dtype=np.float32)
    return arr.reshape(-1, ncols)


def write_label_file(path: str, rows) -> None:
    with open(path, "w") as f:
        for row in rows:
            f.write(" ".join(f"{float(v):.6f}" for v in row) + "\n")


def pad_labels(labels: np.ndarray, max_labels: int,
               ncols: int = 5) -> np.ndarray:
    """Empty -> one all-ones sentinel row; then pad to max_labels rows
    with 1e-6."""
    if labels.shape[0] == 0:
        labels = np.full((1, ncols), EMPTY_SENTINEL, dtype=np.float32)
    n = labels.shape[0]
    if n > max_labels:
        return labels[:max_labels].astype(np.float32)
    out = np.full((max_labels, ncols), PAD_VALUE, dtype=np.float32)
    out[:n] = labels
    return out


def count_instances(lab_dir: str) -> tuple[int, List[int]]:
    """Total labeled instances and per-file counts over a label dir
    (empty files are skipped)."""
    total, per_file = 0, []
    for name in sorted(os.listdir(lab_dir)):
        if not name.endswith(".txt"):
            continue
        path = os.path.join(lab_dir, name)
        if os.path.getsize(path):
            with open(path) as f:
                n = sum(1 for _ in f)
            total += n
            per_file.append(n)
    return total, per_file


def filter_min_box_scale(labels: np.ndarray,
                         min_box_scale: float) -> np.ndarray:
    """Drop rows whose width (col 3) is below min_box_scale."""
    if labels.size == 0:
        return labels
    return labels[labels[:, 3] >= min_box_scale]
