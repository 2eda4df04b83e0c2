"""Per-image PGD fabrication attack (the JAX package's ``attack/pgd.py``):
an L-inf-bounded per-image perturbation (not a patch) that makes the
detector fabricate objects everywhere, by sign-gradient steps with an
eps-ball projection, maximizing the mean sigmoid objectness over every
anchor (the reference's abandoned TOG fabrication script, completed),
batched over images:

    x_{t+1} = clip_eps( x_t + alpha * sign( d/dx mean sigmoid(obj) ) )

Each step takes ``torch.autograd.grad`` of the loss with respect to the
images. On CUDA the victim runs its stem kernels as the ``Detector``
does (the fused stem, forward K3a -> K1 ``save_acts`` -> K3b and
backward K3a -> K2; else the planar stem; the conv walk where neither
geometry matches); on the CPU the conv walk. A float32 victim runs its
forward and its backward with TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch

from ..models.darknet import Darknet, Network, Params
from ..ops import _cuda


@dataclasses.dataclass(frozen=True)
class PGDConfig:
    eps: float = 8.0 / 255.0       # L-inf budget
    alpha: float = 2.0 / 255.0     # step size
    steps: int = 10
    targeted_class: Optional[int] = None   # also push one class's score up


def fabrication_loss(heads: Sequence[torch.Tensor], num_classes: int = 15,
                     targeted_class: Optional[int] = None) -> torch.Tensor:
    """Mean sigmoid objectness over every anchor of every scale (plus
    the targeted class's mean score when requested): maximized."""
    total = 0.0
    count = 0
    for head in heads:
        b, s, _, _ = head.shape
        x = head.reshape(b, s, s, 3, 5 + num_classes)
        total = total + torch.sum(torch.sigmoid(x[..., 4]))
        if targeted_class is not None:
            total = total + torch.sum(torch.sigmoid(
                x[..., 5 + targeted_class]))
        count += x[..., 4].numel()
    return total / count


def fabrication_grad(model: Darknet, images: torch.Tensor,
                     num_classes: int = 15,
                     targeted_class: Optional[int] = None) -> torch.Tensor:
    """d ``fabrication_loss`` / d images [B, S, S, 3] through ``model``,
    on its stem kernels when the images lie on a card."""
    kernels = images.device.type == "cuda"
    tf32 = (_cuda.no_tf32() if model.compute_dtype == torch.float32
            else contextlib.nullcontext())
    with tf32, torch.enable_grad():
        x = images.detach().requires_grad_(True)
        heads = model(x, fused_stem=kernels, planar_stem=kernels)
        loss = fabrication_loss(heads, num_classes, targeted_class)
        (g,) = torch.autograd.grad(loss, x)
    return g


def make_pgd_fabrication(net: Network, cfg: PGDConfig = PGDConfig(),
                         num_classes: int = 15,
                         compute_dtype: torch.dtype = torch.float32):
    """Build the attack: (params, images [B, S, S, 3] in [0, 1], on the
    device to run on) -> adversarial images (same shape, within eps of
    the images and in [0, 1])."""

    def attack(params: Params, images: torch.Tensor) -> torch.Tensor:
        model = Darknet(net, params, compute_dtype, device=images.device)
        lo = torch.clamp(images - cfg.eps, 0.0, 1.0)
        hi = torch.clamp(images + cfg.eps, 0.0, 1.0)
        x = images
        for _ in range(cfg.steps):
            g = fabrication_grad(model, x, num_classes, cfg.targeted_class)
            x = torch.clamp(x + cfg.alpha * torch.sign(g), lo, hi)
        return x

    return attack
