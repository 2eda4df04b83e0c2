"""Creation-attack losses (the JAX package's ``attack/losses.py``).

- cell extraction of objectness/class scores at the patch's grid cell on
  all three scales;
- the creation objective ``no_obj = 4 * (1 - mean(max_9 obj))``;
- targeted class CE over softmax of the *sigmoided* class scores (the
  reference feeds probabilities to CrossEntropyLoss), and the margin
  variant;
- non-printability score, total variation, Hasler-Suesstrunk
  colorfulness;
- whole-image max obj/cls extraction for the legacy recipes.

Reference quirk kept: the cell index is
``floor(center_x/stride) * S + floor(center_y/stride)`` while the head's
flat layout is row-major ``y * S + x``, so the extracted cell has its
x/y *swapped*; ``swap_xy=True`` (default) reproduces it.
"""

from __future__ import annotations

from typing import Sequence

import torch


def nps_loss(patch: torch.Tensor,
             printable_colors: torch.Tensor) -> torch.Tensor:
    """Non-printability score. patch [P, P, 3]; colors [K, 3]. Per pixel:
    min over the K colors of sqrt(sum_c (p - c + 1e-6)^2 + 1e-6); summed,
    divided by patch numel."""
    diff = patch[None] - printable_colors[:, None, None, :] + 0.000001
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 0.000001)
    return torch.sum(torch.amin(dist, dim=0)) / patch.numel()


def total_variation(patch: torch.Tensor) -> torch.Tensor:
    """Mean |dx| + |dy| with the reference's +1e-6 inside the abs."""
    dx = torch.abs(patch[:, 1:, :] - patch[:, :-1, :] + 0.000001)
    dy = torch.abs(patch[1:, :, :] - patch[:-1, :, :] + 0.000001)
    return (torch.sum(dx) + torch.sum(dy)) / patch.numel()


def colorfulness(patch: torch.Tensor) -> torch.Tensor:
    """Hasler-Suesstrunk colorfulness of an RGB patch [P, P, 3], with the
    unbiased variance."""
    r, g, b = patch[..., 0], patch[..., 1], patch[..., 2]
    rg = r - g
    yb = 0.5 * (r + g) - b
    sigma = torch.sqrt(torch.var(rg, correction=1)
                       + torch.var(yb, correction=1))
    mu = torch.sqrt(torch.mean(rg) ** 2 + torch.mean(yb) ** 2)
    return sigma + 0.3 * mu


def extract_cell_scores(heads: Sequence[torch.Tensor],
                        centers: torch.Tensor, img_size: int,
                        num_classes: int = 15, swap_xy: bool = True):
    """Sigmoided (obj, cls) scores of the patch's cell on each scale.

    heads: raw NHWC heads [B, S, S, 3*(5+C)]; centers: [B, 2] pixel (x, y).
    Returns (obj [B, 3*n_heads], cls [B, 3*n_heads, C]) in scale-major,
    anchor-minor order."""
    objs, clss = [], []
    batch = centers.shape[0]
    bidx = torch.arange(batch, device=centers.device)
    for head in heads:
        s = head.shape[1]
        stride = img_size // s
        cell = torch.div(centers.to(torch.int32), stride,
                         rounding_mode="floor").long()
        cx, cy = cell[:, 0], cell[:, 1]
        row, col = (cx, cy) if swap_xy else (cy, cx)
        cells = head[bidx, row, col].reshape(batch, 3, 5 + num_classes)
        scores = torch.sigmoid(cells[..., 4:])
        objs.append(scores[..., 0])
        clss.append(scores[..., 1:])
    return torch.cat(objs, dim=1), torch.cat(clss, dim=1)


def weighted_mean(x: torch.Tensor, weights=None) -> torch.Tensor:
    """Mean of x [B] over the batch; with ``weights`` [B] (1 = real
    sample, 0 = padding) the mean runs over real samples only."""
    if weights is None:
        return torch.mean(x)
    return torch.sum(x * weights) / torch.clamp(torch.sum(weights), min=1.0)


def creation_obj_loss(cell_obj: torch.Tensor, weights=None) -> torch.Tensor:
    """4 * (1 - mean over batch of the max objectness among the cell's
    anchors)."""
    return 4.0 * (1.0 - weighted_mean(torch.amax(cell_obj, dim=1), weights))


def creation_cls_ce_loss(cell_cls: torch.Tensor, target_id: int,
                         weights=None) -> torch.Tensor:
    """Targeted CE over the anchors' *sigmoided* class scores: mean over
    anchors, then over the batch."""
    logp = torch.log_softmax(cell_cls, dim=-1)
    return -weighted_mean(torch.mean(logp[..., target_id], dim=1), weights)


def creation_cls_margin_loss(cell_cls: torch.Tensor,
                             target_id: int) -> torch.Tensor:
    """Sum over batch of mean over anchors of (max class prob - target
    class prob)."""
    diff = torch.amax(cell_cls, dim=-1) - cell_cls[..., target_id]
    return torch.sum(torch.mean(diff, dim=1))


def max_prob_extract(heads: Sequence[torch.Tensor], cls_id: int,
                     num_classes: int = 15, sigmoid_mode: bool = False):
    """Whole-image max objectness and max target-class score (raw logits
    unless ``sigmoid_mode``). Returns (max_obj [B], max_cls [B])."""
    objs, clss = [], []
    for head in heads:
        b, s = head.shape[:2]
        x = head.reshape(b, s, s, 3, 5 + num_classes)
        obj = x[..., 4].reshape(b, -1)
        cls = x[..., 5 + cls_id].reshape(b, -1)
        if sigmoid_mode:
            obj, cls = torch.sigmoid(obj), torch.sigmoid(cls)
        objs.append(obj)
        clss.append(cls)
    return (torch.amax(torch.cat(objs, dim=1), dim=1),
            torch.amax(torch.cat(clss, dim=1), dim=1))


def max_combined_prob(heads: Sequence[torch.Tensor], cls_id: int, combiner,
                      num_classes: int = 15, sigmoid_mode: bool = False
                      ) -> torch.Tensor:
    """Per-image max over all positions of ``combiner(obj, cls[cls_id])``.
    Returns [B]."""
    vals = []
    for head in heads:
        b, s = head.shape[:2]
        x = head.reshape(b, s, s, 3, 5 + num_classes)
        obj = x[..., 4]
        cls = x[..., 5 + cls_id]
        if sigmoid_mode:
            obj, cls = torch.sigmoid(obj), torch.sigmoid(cls)
        vals.append(combiner(obj, cls).reshape(b, -1))
    return torch.amax(torch.cat(vals, dim=1), dim=1)
