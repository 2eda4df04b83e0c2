"""Bundled data assets: DOTA class names, decode-time anchor groups, and
the 30 printable colors for the NPS loss.

Provenance: these are *data* constants of the attack protocol, not code —
the DOTA class list (public dataset), the 9 YOLOv3-DOTA anchors in the
reference's file ordering (required for detection parity), and the 30
printable-RGB calibration triplets the NPS loss is defined over
(reference non_printability/30values.txt; the values ARE the loss
definition, so they must match numerically).

``load_anchor_groups`` replicates (deliberately) the reference's anchor
pairing quirk (utils.py:441-447): the anchor file lists the 3 groups
large->small, is reshaped to [3, 3, 2], and the *group order is reversed*,
so the stride-32 (19x19) head decodes with the *small* anchors and the
stride-8 (76x76) head with the *large* ones — the opposite of the cfg's
mask assignment. Detections only match the reference bit-for-bit with this
pairing, so it is the default; pass ``quirk=False`` for the cfg-faithful
pairing.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")
ANCHOR_FILE = os.path.join(ASSET_DIR, "yolov3_anchors.txt")
DOTA_NAMES_FILE = os.path.join(ASSET_DIR, "dota.names")
PRINTABLE_COLORS_FILE = os.path.join(ASSET_DIR, "printable_colors_30.txt")


def load_class_names(path: str = DOTA_NAMES_FILE) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def load_anchor_groups(path: str = ANCHOR_FILE, quirk: bool = True
                       ) -> np.ndarray:
    """Anchor groups [3, 3, 2] in head order (stride 32, 16, 8)."""
    with open(path) as f:
        values = [float(v) for v in f.readline().split(",")]
    groups = np.array(values).reshape(-1, 3, 2)
    return groups[::-1].copy() if quirk else groups


def load_printable_colors(path: str = PRINTABLE_COLORS_FILE) -> np.ndarray:
    """The 30 printable RGB triplets, [30, 3] float32 in [0, 1]."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                rows.append([float(v) for v in line.split(",")])
    return np.asarray(rows, dtype=np.float32)
