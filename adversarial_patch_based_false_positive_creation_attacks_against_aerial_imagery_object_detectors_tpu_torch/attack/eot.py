"""Expectation-over-transformation patch pipeline (train mode).

The JAX package's ``attack/eot.py`` (the reference's ``PatchTransformer``
+ ``PatchApplier``):

  median-pool(7x7) -> per-sample contrast/brightness/uniform-noise ->
  clamp -> random rotation U(-pi, pi) -> scale from a reference box ->
  random center -> one inverse-affine warp -> clamp -> mask -> composite.

Drawing is separate from applying: ``draw_eot`` fills an ``EOTDraws``
record from an explicit ``torch.Generator``, and the transforms take the
draws. The same draws give the same EOT as the JAX package's (whose
tests rebuild them from its key splits).

Reference quirks kept as the JAX package keeps them: the reference box
averages the largest- and smallest-area label rows (the smallest is
almost always a 1e-6 padding row); the patch size uses label *columns 2
and 3*; empty scenes (all-ones sentinel, area > 0.99) take a 0.25 dummy
row; the center is clamped as x = max(U, 0.2), y = min(U, 0.8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..ops.affine import affine_sample, rotation_scale_translation_theta
from ..ops.affine_mxu import affine_warp_mxu
from ..ops.median_pool import median_pool_nhwc_fast


@dataclasses.dataclass(frozen=True)
class EOTConfig:
    img_size: int = 608
    scale_factor: float = 2.0
    min_contrast: float = 0.8
    max_contrast: float = 1.2
    min_brightness: float = -0.1
    max_brightness: float = 0.1
    noise_factor: float = 0.10
    min_angle: float = -math.pi
    max_angle: float = math.pi
    do_rotate: bool = True
    photometric: bool = True
    median_kernel: int = 7
    size_cols: Tuple[int, int] = (2, 3)
    center_clamp: Tuple[float, float] = (0.2, 0.8)
    warp_method: str = "mxu"             # "mxu" | "gather"
    # dtype of the geometric half (warp + composite); None keeps the
    # patch's (float32)
    warp_dtype: Optional[str] = None


@dataclasses.dataclass
class EOTDraws:
    """The random numbers of one EOT batch: ``contrast``, ``brightness``
    [B] (already in their ranges), ``noise`` [B, P, P, 3] raw U(-1, 1)
    (scaled by ``noise_factor`` when applied), ``ux``, ``uy`` [B] raw
    U(0, 1) centers (clamped when applied), ``angle`` [B] radians."""
    contrast: torch.Tensor
    brightness: torch.Tensor
    noise: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    angle: torch.Tensor


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return lo + (hi - lo) * u


def draw_eot(generator: torch.Generator, batch: int, patch_size: int,
             cfg: EOTConfig = EOTConfig()) -> EOTDraws:
    """One batch of EOT draws from ``generator``, on its device."""
    dev = generator.device
    return EOTDraws(
        contrast=_uniform(generator, (batch,), cfg.min_contrast,
                          cfg.max_contrast, dev),
        brightness=_uniform(generator, (batch,), cfg.min_brightness,
                            cfg.max_brightness, dev),
        noise=_uniform(generator, (batch, patch_size, patch_size, 3), -1.0,
                       1.0, dev),
        ux=_uniform(generator, (batch,), 0.0, 1.0, dev),
        uy=_uniform(generator, (batch,), 0.0, 1.0, dev),
        angle=_uniform(generator, (batch,), cfg.min_angle, cfg.max_angle,
                       dev))


def select_reference_box(labels: torch.Tensor) -> torch.Tensor:
    """Per-sample reference row: mean of the largest- and smallest-area
    label rows, or a 0.25 dummy for empty scenes. labels: [B, L, 5]
    (cls, x, y, w, h normalized). Returns [B, 5]."""
    area = labels[..., 3] * labels[..., 4]
    bidx = torch.arange(labels.shape[0], device=labels.device)
    selected = (labels[bidx, torch.argmax(area, dim=1)]
                + labels[bidx, torch.argmin(area, dim=1)]) / 2.0
    empty = torch.amax(area, dim=1) > 0.99
    return torch.where(empty[:, None], torch.full_like(selected, 0.25),
                       selected)


def patch_scale_and_center(labels: torch.Tensor, draws: EOTDraws,
                           patch_size: int, cfg: EOTConfig):
    """Per-sample warp zoom, patch centers (pixels), and the clamped
    normalized centers (tx, ty)."""
    ref = select_reference_box(labels)
    c0, c1 = cfg.size_cols
    half = cfg.img_size / cfg.scale_factor
    target_size = torch.sqrt((ref[:, c0] * half) ** 2
                             + (ref[:, c1] * half) ** 2)
    scale = target_size / patch_size
    tx = torch.clamp(draws.ux, min=cfg.center_clamp[0])
    ty = torch.clamp(draws.uy, max=cfg.center_clamp[1])
    centers = torch.stack([tx, ty], dim=1) * cfg.img_size
    return scale, centers, tx, ty


def photometric_jitter(patch: torch.Tensor, draws: EOTDraws,
                       cfg: EOTConfig) -> torch.Tensor:
    """Per-sample contrast/brightness plus per-pixel uniform noise.
    patch: [P, P, 3] -> [B, P, P, 3], clamped to [0, 1]."""
    contrast = draws.contrast[:, None, None, None]
    brightness = draws.brightness[:, None, None, None]
    noise = cfg.noise_factor * draws.noise
    out = patch[None] * contrast + brightness + noise
    return torch.clamp(out, 0.0, 1.0)


def max_zoom_window(img_size: int, patch_size: int,
                    scale_factor: float = 2.0) -> int:
    """Output pixels of slack that cover the worst-case EOT zoom: target
    size <= sqrt(2)*img/scale_factor, so zoom <= that / patch_size."""
    max_zoom = math.sqrt(2.0) * img_size / (scale_factor * patch_size)
    return int(math.ceil(max_zoom * math.sqrt(2.0))) + 1


def warp_patch(batch_patch: torch.Tensor, angle: torch.Tensor,
               scale: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
               img_size: int, method: str = "mxu"):
    """Place per-sample patches [B, P, P, 3] onto the image canvas at
    normalized centers (tx, ty) with the given rotation/zoom. Returns
    (adv, mask). ``method``: "mxu" (the factored warp) or "gather" (the
    exact grid_sample warp)."""
    p = batch_patch.shape[1]
    theta = rotation_scale_translation_theta(
        angle, scale, (0.5 - tx) * 2.0, (0.5 - ty) * 2.0)
    pad = (img_size - p) // 2
    if method == "mxu":
        warped, mask = affine_warp_mxu(
            batch_patch, theta, (img_size, img_size),
            src_hw=(img_size, img_size), offset=(pad, pad))
    elif method == "gather":
        warped, mask = affine_sample(
            batch_patch, theta, (img_size, img_size),
            src_hw=(img_size, img_size), offset=(pad, pad), with_mask=True)
    else:
        raise ValueError(f"unknown warp method {method!r}")
    return torch.clamp(warped, 0.0, 1.0) * mask, mask


def transform_patch(patch: torch.Tensor, labels: torch.Tensor,
                    draws: EOTDraws, cfg: EOTConfig = EOTConfig()):
    """EOT-transform ``patch`` [P, P, 3] for a batch of scenes. Returns
    ``(adv [B, S, S, 3], mask [B, S, S, 1], centers [B, 2])``: ``adv`` is
    the clamped warped patch (mask-multiplied) on the image canvas and
    ``centers`` the patch pixel centers (x, y)."""
    p = patch.shape[0]
    b = labels.shape[0]
    smoothed = median_pool_nhwc_fast(patch, cfg.median_kernel)
    if cfg.photometric:
        batch_patch = photometric_jitter(smoothed, draws, cfg)
    else:
        batch_patch = torch.clamp(smoothed, 0.0, 1.0)[None].expand(
            b, p, p, 3)
    scale, centers, tx, ty = patch_scale_and_center(labels, draws, p, cfg)
    angle = draws.angle if cfg.do_rotate else torch.zeros_like(draws.angle)
    if cfg.warp_dtype is not None:
        batch_patch = batch_patch.to(getattr(torch, cfg.warp_dtype))
    adv, mask = warp_patch(batch_patch, angle, scale, tx, ty, cfg.img_size,
                           method=cfg.warp_method)
    return adv, mask, centers


def paste_patch(images: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
    """Composite: exact-zero adv pixels are transparent (the reference's
    ``torch.where(adv == 0, img, adv)``), in ``adv``'s dtype."""
    return torch.where(adv == 0.0, images.to(adv.dtype), adv)


def apply_eot_patch(patch: torch.Tensor, images: torch.Tensor,
                    labels: torch.Tensor, draws: EOTDraws,
                    cfg: EOTConfig = EOTConfig()):
    """Transform + composite. images: [B, S, S, 3] in [0, 1]. Returns
    (patched images, patch centers [B, 2])."""
    adv, _, centers = transform_patch(patch, labels, draws, cfg)
    return paste_patch(images, adv), centers
