"""IoU and non-maximum suppression, with the greedy semantics of the
reference (utils.py:93-112 ``nms`` over the xywh IoU of utils.py:27-58).

- ``greedy_nms_host``: variable-length, on the host: the eval path. It
  runs the native C++ routine (``utils/native.py``) where that is built,
  else its numpy twin (the same indices, unless an IoU lies within an
  ulp of the threshold: the C++ IoU may contract into fused
  multiply-adds).
- ``merge_nms_host``: the reference's alternative merge-NMS on the host.
- ``greedy_nms_device_batch`` / ``greedy_nms_device``: fixed-size masked
  NMS on the device (``max_det`` slots and a validity mask), with the
  JAX package's pruning contract and ``saturated`` flag.

The device NMS is eager PyTorch: each Jacobi pass is one vectorized
masked reduction over the [B, k, k] suppression matrix, and deciding
whether to run another pass reads one boolean back from the device (one
host sync per pass).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import native

# Jacobi-NMS pass bound before falling back to the exact serial scan
# (see greedy_nms_device_batch); module-level so tests can pin it low.
JACOBI_MAX_PASSES = 32


def iou_xywh_matrix(boxes_a, boxes_b, xp=np):
    """Pairwise IoU for center-format boxes [..., N, 4] x [..., M, 4] ->
    [..., N, M] (numpy with ``xp=np``, tensors with ``xp=torch``).

    Matches the reference's union-box formulation (utils.py:38-58),
    including its behavior on degenerate boxes.
    """
    ax1 = boxes_a[..., 0] - boxes_a[..., 2] / 2.0
    ax2 = boxes_a[..., 0] + boxes_a[..., 2] / 2.0
    ay1 = boxes_a[..., 1] - boxes_a[..., 3] / 2.0
    ay2 = boxes_a[..., 1] + boxes_a[..., 3] / 2.0
    bx1 = boxes_b[..., 0] - boxes_b[..., 2] / 2.0
    bx2 = boxes_b[..., 0] + boxes_b[..., 2] / 2.0
    by1 = boxes_b[..., 1] - boxes_b[..., 3] / 2.0
    by2 = boxes_b[..., 1] + boxes_b[..., 3] / 2.0

    uw = xp.maximum(ax2[..., :, None], bx2[..., None, :]) - xp.minimum(
        ax1[..., :, None], bx1[..., None, :])
    uh = xp.maximum(ay2[..., :, None], by2[..., None, :]) - xp.minimum(
        ay1[..., :, None], by1[..., None, :])
    cw = boxes_a[..., 2][..., :, None] + boxes_b[..., 2][..., None, :] - uw
    ch = boxes_a[..., 3][..., :, None] + boxes_b[..., 3][..., None, :] - uh
    carea = xp.where((cw <= 0) | (ch <= 0), 0.0, cw * ch)
    uarea = (boxes_a[..., 2] * boxes_a[..., 3])[..., :, None] + (
        boxes_b[..., 2] * boxes_b[..., 3])[..., None, :] - carea
    return carea / uarea


def greedy_nms_host(boxes: np.ndarray, scores: np.ndarray,
                    iou_thresh: float) -> np.ndarray:
    """Greedy NMS on host. boxes [N,4] xywh, scores [N]. Returns kept
    indices in descending-score order (ties: lower index first). Uses the
    native routine when it is available."""
    n = len(scores)
    if n == 0:
        return np.zeros((0,), dtype=np.int64)
    kept = native.greedy_nms(boxes, scores, iou_thresh)
    if kept is not None:
        return kept
    order = np.argsort(-scores, kind="stable")
    iou = iou_xywh_matrix(boxes[order], boxes[order])
    alive = np.ones(n, dtype=bool)
    keep = []
    for i in range(n):
        if not alive[i]:
            continue
        keep.append(order[i])
        alive[i + 1:] &= iou[i, i + 1:] <= iou_thresh
    return np.asarray(keep, dtype=np.int64)


def merge_nms_host(boxes: np.ndarray, obj: np.ndarray, cls: np.ndarray,
                   conf_thresh: float = 0.5, iou_thresh: float = 0.5,
                   class_agnostic: bool = False, max_det: int = 300,
                   merge: bool = True) -> np.ndarray:
    """The reference's alternative vectorized NMS (utils.py:639-732
    ``non_max_suppression``): combined score obj*cls, per-class box
    offsets (unless class_agnostic), greedy NMS (stable descending order),
    then merge-NMS: kept boxes are replaced by the IoU-weighted mean of
    their cluster, and kept only if the cluster is redundant (> 1 member).

    boxes [N,4] xywh normalized; obj [N]; cls [N,C] class scores.
    Returns [M, 7] rows (x, y, w, h, obj, cls_conf, cls_id).
    """
    if len(boxes) == 0:
        return np.zeros((0, 7), np.float32)
    keep_cand = obj > conf_thresh
    boxes, obj, cls = boxes[keep_cand], obj[keep_cand], cls[keep_cand]
    if len(boxes) == 0:
        return np.zeros((0, 7), np.float32)
    conf = cls * obj[:, None]
    cls_id = conf.argmax(axis=1)
    score = conf[np.arange(len(conf)), cls_id]
    sel = score > conf_thresh
    boxes, obj, cls_id, score = boxes[sel], obj[sel], cls_id[sel], score[sel]
    if len(boxes) == 0:
        return np.zeros((0, 7), np.float32)
    # per-class offset trick: disjoint coordinate islands per class
    off = 0.0 if class_agnostic else cls_id.astype(np.float32) * 8.0
    shifted = boxes.copy()
    shifted[:, 0] += off
    keep = greedy_nms_host(shifted, score, iou_thresh)[:max_det]
    out_boxes = boxes[keep].copy()
    if merge and 1 < len(boxes) < 3000:
        iou = iou_xywh_matrix(shifted[keep], shifted)
        clusters = iou > iou_thresh
        weights = clusters * score[None, :]
        denom = weights.sum(axis=1, keepdims=True)
        out_boxes = (weights @ boxes) / np.maximum(denom, 1e-12)
        redundant = clusters.sum(axis=1) > 1
        keep = keep[redundant]
        out_boxes = out_boxes[redundant]
    return np.concatenate([
        out_boxes, obj[keep, None],
        (score[keep] / np.maximum(obj[keep], 1e-12))[:, None],
        cls_id[keep, None].astype(np.float32)], axis=1).astype(np.float32)


def _nms_prep(boxes, scores, iou_thresh, max_det):
    """Top-k prune + suppression matrix over a batch. Returns (top_idx
    [B,k], sup_mat [B,k,k], valid [B,k]) with sup_mat[b, j, i]:
    higher-ranked j suppresses i while j is alive. A stable descending
    sort ranks ties by lower index, as ``lax.top_k`` does."""
    n = scores.shape[-1]
    k = min(max_det * 8, n)  # prune candidates before the O(k^2) IoU
    top_idx = torch.sort(scores, dim=-1, descending=True,
                         stable=True).indices[..., :k]
    top_scores = torch.gather(scores, -1, top_idx)
    top_boxes = torch.gather(
        boxes, -2, top_idx[..., None].expand(*top_idx.shape, 4))
    iou = iou_xywh_matrix(top_boxes, top_boxes, xp=torch)
    rk = torch.arange(k, device=scores.device)
    sup_mat = (iou > iou_thresh) & (rk[:, None] < rk[None, :])
    return top_idx, sup_mat, top_scores > 0


def _jacobi_alive(sup_mat, valid, max_passes):
    """Jacobi iteration toward the greedy fixpoint, capped. Returns
    (alive [B,k], converged [B]). An image already at its fixpoint is
    unchanged by further passes, so iterating the batch together gives
    each image what its own loop would."""
    alive = valid
    prev = torch.zeros_like(valid)
    passes = 0
    while passes < max_passes and bool((alive != prev).any()):
        prev, alive = alive, valid & ~torch.any(
            sup_mat & alive[..., :, None], dim=-2)
        passes += 1
    return alive, ~torch.any(alive != prev, dim=-1)


def _serial_alive(sup_mat, valid):
    """Textbook rank-order scan: if i is alive it kills every
    lower-ranked overlap; exact by construction."""
    alive = valid.clone()
    for i in range(sup_mat.shape[-1]):
        alive &= ~(sup_mat[..., i, :] & alive[..., i:i + 1])
    return alive


def _compact(alive, top_idx, max_det):
    """Survivors to the first max_det slots."""
    b = alive.shape[0]
    rank = torch.cumsum(alive.long(), dim=-1) - 1
    in_range = alive & (rank < max_det)
    slot = torch.where(in_range, rank, torch.full_like(rank, max_det))
    out_idx = torch.zeros((b, max_det + 1), dtype=top_idx.dtype,
                          device=top_idx.device)
    out_valid = torch.zeros((b, max_det + 1), dtype=torch.bool,
                            device=alive.device)
    out_idx.scatter_(-1, slot, top_idx)     # slot max_det is discarded
    out_valid.scatter_(-1, slot, in_range)
    return out_idx[:, :max_det], out_valid[:, :max_det]


def greedy_nms_device_batch(boxes: torch.Tensor, scores: torch.Tensor,
                            iou_thresh: float, max_det: int):
    """Batched fixed-size greedy NMS: boxes [B,N,4], scores [B,N] (invalid
    candidates carry score <= 0) -> (indices [B,max_det], valid
    [B,max_det], saturated [B] bool).

    Only the top ``k = 8*max_det`` candidates by score are considered;
    ``saturated[b]`` is True exactly when image b had more than k
    positive-score candidates (the cut may then have dropped would-be
    survivors), constant False when n <= k. Capped Jacobi passes run on
    the whole batch; if any image did not converge, the exact serial scan
    runs once for the batch, so the result is the greedy fixpoint
    either way."""
    top_idx, sup_mat, valid = _nms_prep(boxes, scores, iou_thresh, max_det)
    if scores.shape[-1] > top_idx.shape[-1]:  # n > k: prune was real
        saturated = valid[:, -1]
    else:
        saturated = torch.zeros(scores.shape[0], dtype=torch.bool,
                                device=scores.device)
    alive, converged = _jacobi_alive(sup_mat, valid, JACOBI_MAX_PASSES)
    if not bool(converged.all()):
        alive = _serial_alive(sup_mat, valid)
    out_idx, out_valid = _compact(alive, top_idx, max_det)
    return out_idx, out_valid, saturated


def greedy_nms_device(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_thresh: float, max_det: int):
    """Single-image ``greedy_nms_device_batch``: boxes [N,4], scores [N]
    -> (indices [max_det], valid [max_det], saturated scalar bool)."""
    idx, valid, sat = greedy_nms_device_batch(
        boxes[None], scores[None], iou_thresh, max_det)
    return idx[0], valid[0], sat[0]
