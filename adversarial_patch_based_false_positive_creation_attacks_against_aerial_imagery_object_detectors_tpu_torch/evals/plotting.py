"""Detection visualization (reference utils.py:294-380 ``plot_boxes``).

Draws 7-col detections on a PIL image with the per-class color hash the
reference uses (offset = cls_id * 123457 % classes over a 6-color ramp)
and a ``class score`` label (score = obj * cls_conf). The reference
depends on a bundled ``simhei.ttf`` (absent from its repo); we fall back
to PIL's default bitmap font.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont

_RAMP = np.array([[1, 0, 1], [0, 0, 1], [0, 1, 1],
                  [0, 1, 0], [1, 1, 0], [1, 0, 0]], dtype=np.float64)


def class_color(cls_id: int, num_classes: int) -> tuple:
    offset = cls_id * 123457 % num_classes

    def channel(c):
        ratio = offset / num_classes * 5
        i, j = int(math.floor(ratio)), int(math.ceil(ratio))
        r = ratio - i
        return int(((1 - r) * _RAMP[i][c] + r * _RAMP[j][c]) * 255)

    return channel(2), channel(1), channel(0)


def draw_detections(img: Image.Image, dets: np.ndarray,
                    class_names: Sequence[str],
                    savename: Optional[str] = None) -> Image.Image:
    """dets: [N, 7] normalized (x, y, w, h, obj, cls_conf, cls_id)."""
    draw = ImageDraw.Draw(img)
    w, h = img.size
    try:
        font = ImageFont.truetype(
            "DejaVuSans.ttf", size=int(3e-2 * w + 0.5))
    except OSError:
        font = ImageFont.load_default()
    for det in dets:
        if not np.isfinite(det[:4]).all():
            continue  # exp-overflow boxes from untrained weights
        x1 = float(np.clip((det[0] - det[2] / 2) * w, -4 * w, 4 * w))
        y1 = float(np.clip((det[1] - det[3] / 2) * h, -4 * h, 4 * h))
        x2 = float(np.clip((det[0] + det[2] / 2) * w, -4 * w, 4 * w))
        y2 = float(np.clip((det[1] + det[3] / 2) * h, -4 * h, 4 * h))
        cls_id = int(det[6])
        rgb = class_color(cls_id, len(class_names))
        score = det[4] * det[5]
        label = f"{class_names[cls_id]}{score:.2f}"
        tw = draw.textlength(label, font)
        draw.rectangle([x1, y1, x1 + tw, y1 + 12], fill=(255, 0, 0))
        draw.text((x1, y1), label, fill=(0, 0, 0), font=font)
        draw.rectangle([x1, y1, x2, y2], outline=rgb, width=2)
    if savename:
        img.save(savename)
    return img
