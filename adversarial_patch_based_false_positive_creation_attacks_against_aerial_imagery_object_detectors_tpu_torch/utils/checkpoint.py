"""Checkpointing and patch image export.

The patch PNG (8-bit, truncated as torchvision's ``ToPILImage``), the
adjacent-patch MSE between two saved PNGs, and a whole training-state
checkpoint in the port's own format: one ``torch.save`` file holding
tensors and plain values only (the patch, the optimizer's state dict,
the plateau schedule, the EOT generator's state and the epoch), read
back with ``weights_only=True``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from PIL import Image


def save_patch_png(patch, path: str) -> None:
    """patch [P, P, 3] float in [0,1] -> 8-bit PNG (mul(255).byte())."""
    if isinstance(patch, torch.Tensor):
        patch = patch.detach().float().cpu().numpy()
    arr = np.clip(np.asarray(patch) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def load_patch_png(path: str, patch_size: Optional[int] = None
                   ) -> np.ndarray:
    """PNG -> [P, P, 3] float32 in [0,1]; optional bilinear resize."""
    img = Image.open(path).convert("RGB")
    if patch_size is not None and img.size != (patch_size, patch_size):
        img = img.resize((patch_size, patch_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def patch_png_mse(path_a: str, path_b: str) -> float:
    a = load_patch_png(path_a)
    b = load_patch_png(path_b)
    return float(np.mean((a - b) ** 2))


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """``state``: tensors, state dicts and plain values; tensors are
    written from the CPU."""
    def cpu(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu()
        if isinstance(v, dict):
            return {k: cpu(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(cpu(x) for x in v)
        return v
    torch.save(cpu(state), path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)
