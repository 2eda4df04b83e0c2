"""Synthetic scenes from the refparity victims' training distribution.

The port's own copy of ``NUM_CLASSES``, ``_palette`` and ``make_scene``
(``tools/make_refparity_fixture.py``) and of ``_gen_scenes``
(``tools/attack_quality.py``): noisy gray backgrounds with one to three
colored rectangles from a fixed 15-color palette. The mini and slim
victims were trained on this distribution, so the arithmetic and the
order of the random draws are kept as they are: the same seeds give the
same uint8 scenes and boxes.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

NUM_CLASSES = 15
MINI_IMG = 320


# deterministic 15-color class palette (visually distinct-ish)
def _palette(rng):
    return rng.integers(30, 226, size=(NUM_CLASSES, 3))


def make_scene(rng, palette, img=MINI_IMG):
    """img^2 uint8 scene: noisy gray background + colored rectangles.
    Returns (img_u8, boxes) with boxes = [(cx, cy, w, h, cls), ...] px."""
    arr = np.full((img, img, 3), 127, np.float32)
    arr += rng.normal(0, 3, size=(img, img, 1))  # luma noise
    arr += rng.uniform(-12, 12)                  # global brightness
    boxes = []
    for _ in range(int(rng.integers(1, 4))):
        w = float(np.exp(rng.uniform(np.log(12), np.log(180))))
        h = float(np.exp(rng.uniform(np.log(12), np.log(180))))
        cx = float(rng.uniform(w / 2 + 2, img - w / 2 - 2))
        cy = float(rng.uniform(h / 2 + 2, img - h / 2 - 2))
        cls = int(rng.integers(0, NUM_CLASSES))
        x0, x1 = int(cx - w / 2), int(cx + w / 2)
        y0, y1 = int(cy - h / 2), int(cy + h / 2)
        arr[y0:y1, x0:x1] = palette[cls] + rng.normal(0, 2)
        boxes.append((cx, cy, w, h, cls))
    return np.clip(arr, 0, 255).astype(np.uint8), boxes


def _gen_scenes(out_dir, n, seed, img):
    """Raw scene tiles from the victim's training distribution:
    ``scene_{i:04d}.png`` for i < n, drawn from one generator seeded by
    ``seed`` on the victim's palette (seed 7)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    palette = _palette(np.random.default_rng(7))  # victim's palette
    for i in range(n):
        scene, _ = make_scene(rng, palette, img=img)
        Image.fromarray(scene).save(
            os.path.join(out_dir, f"scene_{i:04d}.png"))
