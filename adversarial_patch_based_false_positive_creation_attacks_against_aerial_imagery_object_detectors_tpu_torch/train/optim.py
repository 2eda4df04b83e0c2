"""The patch optimizer: Adam with amsgrad, torch semantics, then a clip.

The reference optimizes the patch with ``optim.Adam([patch], lr=0.03,
amsgrad=True)``; the JAX package re-implements that update
(``train/optim.py: scale_by_torch_amsgrad``):

    m <- b1 m + (1-b1) g          v <- b2 v + (1-b2) g^2
    vmax <- max(vmax, v)
    patch <- patch - lr * (m / (1-b1^t)) / (sqrt(vmax) / sqrt(1-b2^t) + eps)

which is what ``torch.optim.Adam(amsgrad=True)`` computes on the float32
patch. After each step the patch is clipped to [0, 1] in place.
"""

from __future__ import annotations

import torch


def make_optimizer(patch: torch.Tensor, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam([patch], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            amsgrad=True)


def amsgrad_step(optimizer: torch.optim.Adam, patch: torch.Tensor,
                 lr: float) -> None:
    """One update at learning rate ``lr`` (the plateau schedule's), then
    the clip to [0, 1]."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    with torch.no_grad():
        patch.clamp_(0.0, 1.0)
