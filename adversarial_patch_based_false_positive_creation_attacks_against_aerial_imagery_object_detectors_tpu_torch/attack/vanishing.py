"""Legacy vanishing-attack transformer: one patch per labeled object (the
JAX package's ``attack/vanishing.py``; reference
``PatchTransformer_vanishing``, load_data.py:985-1230).

For the classic "make the detector miss" attack the patch is pasted over
*every* labeled box: centered at each label's (x, y), sized
diag(w, h)/8 (``pre_scale=8``), full +-180 deg rotation, photometric
jitter unless ``test_real``, optional 'left' / 'right' horizontal offset
(x -+ w/6) and optional +-0.2*w,h positional jitter (``rand_loc``).

Drawing is separate from applying, as in ``attack/eot.py``:
``draw_vanishing`` fills a ``VanishingDraws`` record from an explicit
``torch.Generator`` and ``transform_patch_vanishing`` applies the draws
it is given. Output: [B, L, S, S, 3] per-label patch canvases; composite
sequentially with ``paste_vanishing``. Padding label rows (1e-6)
collapse to sub-pixel patches that vanish in the composite, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..ops.median_pool import median_pool_nhwc_fast
from .eot import EOTConfig, _uniform, photometric_jitter, warp_patch


@dataclasses.dataclass(frozen=True)
class VanishingConfig:
    img_size: int = 608
    pre_scale: float = 8.0
    min_angle: float = -math.pi
    max_angle: float = math.pi
    do_rotate: bool = True
    rand_loc: bool = False
    orient: Optional[str] = None      # None | "left" | "right"
    test_real: bool = False           # skip photometric jitter
    median_kernel: int = 7


@dataclasses.dataclass
class VanishingDraws:
    """The random numbers of one batch of B*L label rows: ``contrast``,
    ``brightness`` [N] and ``noise`` [N, P, P, 3] as ``EOTDraws`` holds
    them (the jitter's), ``angle`` [N] radians, and ``ox``, ``oy`` [N]
    positional jitter in [-0.2, 0.2) (used with ``rand_loc``)."""
    contrast: torch.Tensor
    brightness: torch.Tensor
    noise: torch.Tensor
    angle: torch.Tensor
    ox: torch.Tensor
    oy: torch.Tensor


def draw_vanishing(generator: torch.Generator, n: int, patch_size: int,
                   cfg: VanishingConfig = VanishingConfig()
                   ) -> VanishingDraws:
    """Draws for ``n`` label rows from ``generator``, on its device."""
    jcfg = EOTConfig(img_size=cfg.img_size)
    dev = generator.device
    return VanishingDraws(
        contrast=_uniform(generator, (n,), jcfg.min_contrast,
                          jcfg.max_contrast, dev),
        brightness=_uniform(generator, (n,), jcfg.min_brightness,
                            jcfg.max_brightness, dev),
        noise=_uniform(generator, (n, patch_size, patch_size, 3), -1.0,
                       1.0, dev),
        angle=_uniform(generator, (n,), cfg.min_angle, cfg.max_angle, dev),
        ox=_uniform(generator, (n,), -0.2, 0.2, dev),
        oy=_uniform(generator, (n,), -0.2, 0.2, dev))


def transform_patch_vanishing(patch: torch.Tensor, labels: torch.Tensor,
                              draws: VanishingDraws,
                              cfg: VanishingConfig = VanishingConfig()
                              ) -> torch.Tensor:
    """patch [P, P, 3], labels [B, L, 5] -> adv [B, L, S, S, 3]."""
    b, l, _ = labels.shape
    p = patch.shape[0]
    s = cfg.img_size
    n = b * l

    smoothed = median_pool_nhwc_fast(patch, cfg.median_kernel)
    if cfg.test_real:
        batch_patch = torch.clamp(smoothed, 0.0, 1.0)[None].expand(
            n, p, p, 3)
    else:
        batch_patch = photometric_jitter(smoothed, draws,
                                         EOTConfig(img_size=s))

    flat = labels.reshape(n, labels.shape[-1])
    target_x = flat[:, 1]
    target_y = flat[:, 2]
    w = flat[:, 3]
    h = flat[:, 4]
    if cfg.rand_loc:
        target_x = target_x + w * draws.ox
        target_y = target_y + h * draws.oy
    if cfg.orient == "left":
        target_x = target_x - w / 6.0
    elif cfg.orient == "right":
        target_x = target_x + w / 6.0

    target_size = torch.sqrt((w * s / cfg.pre_scale) ** 2
                             + (h * s / cfg.pre_scale) ** 2)
    scale = target_size / p
    angle = draws.angle if cfg.do_rotate else torch.zeros_like(draws.angle)

    adv, _ = warp_patch(batch_patch, angle, scale, target_x, target_y, s)
    return adv.reshape(b, l, s, s, 3)


def paste_vanishing(images: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
    """Sequential per-label composite (PatchApplier over the L axis):
    images [B, S, S, 3], adv [B, L, S, S, 3]."""
    out = images
    for layer in adv.unbind(1):
        out = torch.where(layer == 0.0, out, layer)
    return out
