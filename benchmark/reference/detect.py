"""Plain detection post-processing: decode, threshold, greedy NMS.

For each head [B, S, S, 3*(5+C)] (anchor-major channels) and its three
anchors (w, h in pixels):

    x = (sigmoid(t_x) + col) / S      y = (sigmoid(t_y) + row) / S
    w = exp(t_w) * anchor_w / size    h = exp(t_h) * anchor_h / size
    obj = sigmoid(t_obj)              cls = sigmoid(t_cls)

A candidate passes where obj * max(cls) > conf; the candidates are ranked
by obj (a stable sort, ties to the lower index), the top 8 * max_det are
kept, and the greedy scan in rank order keeps a box unless a kept
higher-ranked box overlaps it by IoU > nms (the union-box IoU of the
attack's utilities). The first ``max_det`` survivors are the rows
(x, y, w, h, obj, cls_conf, cls_id). ``dtype=torch.bfloat16`` decodes in
bfloat16: the control of this stage.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def decode(heads: Sequence[torch.Tensor], anchors, size: int,
           num_classes: int, dtype=torch.float32):
    """(boxes [B, N, 4], obj [B, N], cls_conf [B, N], cls_id [B, N])."""
    boxes, objs, confs, ids = [], [], [], []
    for head, anc in zip(heads, anchors):
        head = head.to(dtype)
        b, s = head.shape[:2]
        x = head.reshape(b, s, s, 3, 5 + num_classes)
        grid = torch.arange(s, dtype=dtype, device=head.device)
        a = torch.as_tensor(np.asarray(anc), dtype=dtype, device=head.device)
        bx = (torch.sigmoid(x[..., 0]) + grid[None, None, :, None]) / s
        by = (torch.sigmoid(x[..., 1]) + grid[None, :, None, None]) / s
        bw = torch.exp(x[..., 2]) * a[:, 0][None, None, None, :] / size
        bh = torch.exp(x[..., 3]) * a[:, 1][None, None, None, :] / size
        cls = torch.sigmoid(x[..., 5:])
        n = s * s * 3
        boxes.append(torch.stack([bx, by, bw, bh], -1).reshape(b, n, 4))
        objs.append(torch.sigmoid(x[..., 4]).reshape(b, n))
        confs.append(torch.amax(cls, dim=-1).reshape(b, n))
        ids.append(torch.argmax(cls, dim=-1).to(dtype).reshape(b, n))
    return (torch.cat(boxes, 1).float(), torch.cat(objs, 1).float(),
            torch.cat(confs, 1).float(), torch.cat(ids, 1).float())


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., N, M] of centre-format boxes: the intersection
    from the union box's width and height."""
    ax1, ax2 = a[..., 0] - a[..., 2] / 2.0, a[..., 0] + a[..., 2] / 2.0
    ay1, ay2 = a[..., 1] - a[..., 3] / 2.0, a[..., 1] + a[..., 3] / 2.0
    bx1, bx2 = b[..., 0] - b[..., 2] / 2.0, b[..., 0] + b[..., 2] / 2.0
    by1, by2 = b[..., 1] - b[..., 3] / 2.0, b[..., 1] + b[..., 3] / 2.0
    uw = torch.maximum(ax2[..., :, None], bx2[..., None, :]) - torch.minimum(
        ax1[..., :, None], bx1[..., None, :])
    uh = torch.maximum(ay2[..., :, None], by2[..., None, :]) - torch.minimum(
        ay1[..., :, None], by1[..., None, :])
    cw = a[..., 2][..., :, None] + b[..., 2][..., None, :] - uw
    ch = a[..., 3][..., :, None] + b[..., 3][..., None, :] - uh
    carea = torch.where((cw <= 0) | (ch <= 0), 0.0, cw * ch)
    uarea = (a[..., 2] * a[..., 3])[..., :, None] + (
        b[..., 2] * b[..., 3])[..., None, :] - carea
    return carea / uarea


def detect_rows(heads: Sequence[torch.Tensor], anchors, size: int,
                num_classes: int, conf: float, nms: float,
                max_det: int = 300, dtype=torch.float32) -> List[np.ndarray]:
    """Per image the [N, 7] rows, N <= max_det, in rank order."""
    boxes, obj, cls_conf, cls_id = decode(heads, anchors, size, num_classes,
                                          dtype)
    score = torch.where(obj * cls_conf > conf, obj, torch.zeros_like(obj))
    k = min(8 * max_det, score.shape[1])
    order = torch.sort(score, dim=-1, descending=True,
                       stable=True).indices[:, :k]
    rows = torch.cat([boxes, obj[..., None], cls_conf[..., None],
                      cls_id[..., None]], dim=-1)
    out = []
    for i in range(score.shape[0]):
        top = order[i]
        valid = (score[i, top] > 0).cpu().numpy()
        over = (iou(boxes[i, top], boxes[i, top]) > nms).cpu().numpy()
        alive = valid.copy()
        for j in range(k):
            if alive[j]:
                alive[j + 1:] &= ~over[j, j + 1:]
        keep = np.flatnonzero(alive)[:max_det]
        out.append(rows[i, top].cpu().numpy()[keep])
    return out


def rows_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest difference between two row sets, each value against
    the larger of 1 and the reference's magnitude: 0 where equal
    (equal non-finite values included), inf where the counts differ or
    a finite value meets a non-finite one."""
    if got.shape != want.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    fin_g, fin_w = np.isfinite(got), np.isfinite(want)
    same_nonfinite = ~fin_g & ~fin_w & ((got == want) | (np.isnan(got)
                                                         & np.isnan(want)))
    if np.any((fin_g != fin_w) | (~fin_g & ~same_nonfinite)):
        return float("inf")
    g, w = got[fin_w].astype(np.float64), want[fin_w].astype(np.float64)
    if g.size == 0:
        return 0.0
    return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1.0)))
