"""Eval-time patch placement with interference avoidance (the JAX
package's ``attack/eot_eval.py``; reference ``PatchTransformer_test_mode``,
load_data.py:1233-1722). At test time the patch must land where it does
NOT overlap any existing detection, so the metrics count *created*
objects only:

1. median-pool the patch; **no** photometric jitter; clamp;
2. rotation limited to +-90 deg;
3. reference box from the 7-col (conf 0.01) labels: mean of the largest
   and smallest area rows, a 0.25 dummy when the scene has exactly one
   label row or the all-ones sentinel;
4. stage-1 warp: rotation + scale only; the warped mask's row extent
   gives the patch's bounding half-edge;
5. an occupancy map marks borders and every labeled box dilated by that
   half-edge, filling smallest-area boxes first with the reference's
   early-termination rules (``inter_axis_cal``);
6. a random free pixel becomes the patch center; stage-2 warp translates
   the patch there; clamp, multiply by the mask.

The draws come from the caller's ``np.random.Generator`` in the JAX
function's order (the angle, then the free pixel), so the two stay
comparable draw for draw. The warps run on the patch's device; only the
stage-1 mask comes to the host, for the half-edge and the occupancy map
(native C++ where built, ``utils/native.py``).

The half-edge tests the mask for exactly 1.0, so a bit of the warp's
arithmetic can move it by a pixel, and with it the occupancy map and the
whole placement. The warps are therefore the JAX package's bilinear
gather op for op (``ops/affine.py: bilinear_gather``, not
``grid_sample``), and theta is built on the host in float32 from sines
and cosines rounded from float64, so the CPU and the card place alike.
XLA's float32 sine differs from the correctly rounded one in an ulp for
about 1% of angles; the placement then still agrees unless that ulp
moves the mask's extreme row.

Deliberately replicated quirks: the occupancy map indexes rows with the
label *x*-center and columns with *y*, and the chosen free pixel's row
becomes target_x; labels are treated as NaN/inf-safe; degenerate labels
take a scale floor; the early exit returns ``layers[0:i - 1]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..ops.affine import affine_source_coords, bilinear_gather
from ..ops.median_pool import median_pool_nhwc_fast
from ..utils import native


@dataclasses.dataclass(frozen=True)
class EvalEOTConfig:
    img_size: int = 608
    scale_factor: float = 2.0
    max_angle: float = math.pi / 2      # test_mode: +-90 deg
    median_kernel: int = 7


def select_reference_box_7col(labels: np.ndarray) -> np.ndarray:
    """labels [L, 7] -> [7] reference row (load_data.py:1295-1318).
    Non-finite rows (exp-overflow detections from untrained victims) are
    treated as zero-area."""
    if len(labels) == 1:
        return np.full(7, 0.25, np.float32)
    labels = np.nan_to_num(labels, nan=0.0, posinf=0.0, neginf=0.0)
    area = labels[:, 2] * labels[:, 3]
    if area.max() > 0.99:
        return np.full(7, 0.25, np.float32)
    sel = (labels[area.argmax()] + labels[area.argmin()]) / 2.0
    return sel.astype(np.float32)


def interference_map(labels: np.ndarray, semi_edge: float,
                     img_size: int) -> np.ndarray:
    """Occupancy map over the canvas (inter_axis_cal parity, including
    the early-termination layer-dropping rules). labels: [L, 7]
    normalized. Returns [S, S] float; free cells are exactly 0.
    Uses the native C++ routine when it is available."""
    # exp-overflow detections (untrained victims) would overflow the
    # integer box fills; treat them as zero-size
    labels = np.nan_to_num(labels, nan=0.0, posinf=0.0, neginf=0.0)
    out = native.interference_map(labels, semi_edge, img_size)
    if out is not None:
        return out
    se = int(semi_edge)
    labs = labels * img_size
    order = np.argsort(labs[:, 2] * labs[:, 3], kind="stable")
    n = len(labs)
    layers = np.zeros((n, img_size, img_size), np.float32)
    if se > 0:
        layers[:, :se, :] = 1
        layers[:, -se:, :] = 1
        layers[:, :, :se] = 1
        layers[:, :, -se:] = 1
    for i in range(n):
        if not (layers.sum(axis=0) == 0).any():
            return layers[0:i - 1].sum(axis=0)
        row = labs[order[i]]
        cx, cy, w, h = row[0], row[1], row[2], row[3]
        # reference quirk: rows indexed by x-center, cols by y-center
        r0, r1 = int(cx - w / 2 - se), int(cx + w / 2 + se)
        c0, c1 = int(cy - h / 2 - se), int(cy + h / 2 + se)
        layers[i, max(r0, 0):max(r1, 0), max(c0, 0):max(c1, 0)] = 1
    total = layers.sum(axis=0)
    if not (total == 0).any():
        return layers[0:n - 1].sum(axis=0)
    return total


def mask_semi_edge(mask: np.ndarray) -> float:
    """Half the row-extent of the warped mask (load_data.py:1650-1664)."""
    rows = np.nonzero(mask[..., 0] == 1.0)[0]
    if len(rows) == 0:
        rows = np.nonzero(mask[..., 0] > 0)[0]
    if len(rows) == 0:
        return 0.0
    return float(rows.max() - rows.min()) / 2.0


def _theta(angle: float, scale: float) -> np.ndarray:
    """``rotation_scale_translation_theta`` at zero translation, [1, 2, 3]
    float32, on the host: the float32 angle's sine and cosine rounded from
    float64, then the products in float32, as the JAX function forms
    them."""
    a = np.float64(np.float32(angle))
    sin, cos = np.float32(math.sin(a)), np.float32(math.cos(a))
    inv = np.float32(1.0) / np.float32(scale)
    return np.array([[[cos * inv, sin * inv, 0.0],
                      [-sin * inv, cos * inv, 0.0]]], np.float32)


def _sample(img: torch.Tensor, theta: np.ndarray, s: int, offset: int = 0,
            with_mask: bool = False):
    """The JAX package's ``affine_sample`` onto an [S, S] canvas whose
    source space is [S, S] (``offset``: the patch's pad in it)."""
    theta = torch.from_numpy(theta).to(img.device)
    ix, iy = affine_source_coords(theta, (s, s), (s, s))
    return bilinear_gather(img, ix - offset, iy - offset, with_mask)


def transform_patch_eval(patch: torch.Tensor, labels: np.ndarray,
                         rng: np.random.Generator,
                         cfg: EvalEOTConfig = EvalEOTConfig()
                         ) -> Tuple[torch.Tensor, Tuple[float, float]]:
    """Place ``patch`` [P, P, 3] (float32, on any device) on one scene with
    labels [L, 7]. Returns (adv [S, S, 3] masked warped patch on the
    patch's device, (target_x, target_y) normalized center). Composite
    with ``paste_patch``."""
    s = cfg.img_size
    p = patch.shape[0]
    smoothed = torch.clamp(
        median_pool_nhwc_fast(patch, cfg.median_kernel), 0.0, 1.0)[None]

    ref = select_reference_box_7col(labels)
    half = s / cfg.scale_factor
    target_size = math.sqrt((ref[2] * half) ** 2 + (ref[3] * half) ** 2)
    # degenerate labels (every row exp-overflow garbage, sanitized to
    # zero) give scale 0, which the inverse warp would invert into a NaN
    # canvas: a visible floor, as the JAX function takes
    scale = min(max(target_size / p, 1e-2), s / p)
    angle = float(rng.uniform(-cfg.max_angle, cfg.max_angle))

    # stage 1: rotation + scale about the canvas center
    stage1, mask1 = _sample(smoothed, _theta(angle, scale), s,
                            offset=(s - p) // 2, with_mask=True)
    semi_edge = mask_semi_edge(mask1[0].cpu().numpy())

    occupancy = interference_map(labels, semi_edge, s)
    free = np.argwhere(occupancy == 0)
    if len(free) == 0:
        free = np.array([[s // 2, s // 2]])
    pick = free[rng.integers(0, len(free))]
    target_x = float(pick[0]) / s        # row -> x (reference quirk)
    target_y = float(pick[1]) / s

    # stage 2: pure translation of the stage-1 canvas and its mask
    theta2 = np.asarray([[[1.0, 0.0, (0.5 - target_x) * 2.0],
                          [0.0, 1.0, (0.5 - target_y) * 2.0]]], np.float32)
    moved = _sample(torch.cat([stage1, mask1], dim=-1), theta2, s)
    adv = torch.clamp(moved[..., :3], 0.0, 1.0) * moved[..., 3:]
    return adv[0], (target_x, target_y)
