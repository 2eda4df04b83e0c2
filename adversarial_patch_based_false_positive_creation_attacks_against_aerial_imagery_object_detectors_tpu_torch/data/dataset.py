"""Image loading and the square-pad + resize preprocessing that the serve
handler applies to every request (the JAX package's ``data/dataset.py``
``load_image_rgb`` and ``pad_and_scale``; the dataset and batch loader
belong to the training slice).

Preprocessing parity with the reference's ``DotaDataset``: non-square
images are squared by gray-127 padding with label coordinate fixup, then
resized (bilinear) to ``img_size``; images come back float32 in [0, 1],
NHWC.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image, ImageOps


def load_image_rgb(path: str) -> Image.Image:
    """PIL load with EXIF orientation fixup."""
    img = Image.open(path)
    img = ImageOps.exif_transpose(img)
    return img.convert("RGB")


def pad_and_scale(img: Image.Image, labels: np.ndarray, img_size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Square by gray padding (adjusting normalized label coords), resize
    to img_size, return float32 [0,1] HWC array + fixed labels."""
    w, h = img.size
    labels = labels.copy()
    if w != h:
        side = max(w, h)
        canvas = Image.new("RGB", (side, side), color=(127, 127, 127))
        if w < h:
            pad = (h - w) / 2
            canvas.paste(img, (int(pad), 0))
            if labels.size:
                labels[:, 1] = (labels[:, 1] * w + pad) / h
                labels[:, 3] = labels[:, 3] * w / h
        else:
            pad = (w - h) / 2
            canvas.paste(img, (0, int(pad)))
            if labels.size:
                labels[:, 2] = (labels[:, 2] * h + pad) / w
                labels[:, 4] = labels[:, 4] * h / w
        img = canvas
    if img.size != (img_size, img_size):
        img = img.resize((img_size, img_size), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr, labels
