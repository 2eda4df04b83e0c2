"""Raw-head -> box decode, one batched elementwise pass:

    x = (sigmoid(t_x) + grid_x) / S        y = (sigmoid(t_y) + grid_y) / S
    w = exp(t_w) * anchor_w / img_w        h = exp(t_h) * anchor_h / img_h
    obj = sigmoid(t_obj)                   cls = sigmoid(t_cls)

Heads are NHWC ``[B, S, S, 3*(5+C)]``; ``head.reshape(B, S, S, 3, 5+C)``
is the anchor-major channel order ``a*(5+C)+c`` of the reference, so
decoded values agree with it elementwise. Outputs are normalized to
[0, 1] image coordinates.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def decode_head(head: torch.Tensor, anchors: np.ndarray,
                img_size: Tuple[int, int], num_classes: int = 15):
    """Decode one raw head [B, S, S, 3*(5+C)] with anchors [3, 2] (w, h in
    pixels). Returns (boxes [B, S*S*3, 4] normalized xywh, obj
    [B, S*S*3], cls [B, S*S*3, C] sigmoid class scores)."""
    b, s, s2, _ = head.shape
    if s != s2:
        raise ValueError(f"decode_head: non-square head {tuple(head.shape)}")
    x = head.reshape(b, s, s, 3, 5 + num_classes)
    grid = torch.arange(s, dtype=head.dtype, device=head.device)
    gx = grid[None, None, :, None]  # columns -> x
    gy = grid[None, :, None, None]  # rows    -> y
    bx = (torch.sigmoid(x[..., 0]) + gx) / s
    by = (torch.sigmoid(x[..., 1]) + gy) / s
    anc = torch.as_tensor(np.asarray(anchors), dtype=head.dtype,
                          device=head.device)
    aw = anc[:, 0][None, None, None, :]
    ah = anc[:, 1][None, None, None, :]
    bw = torch.exp(x[..., 2]) * aw / img_size[0]
    bh = torch.exp(x[..., 3]) * ah / img_size[1]
    obj = torch.sigmoid(x[..., 4])
    cls = torch.sigmoid(x[..., 5:])
    boxes = torch.stack([bx, by, bw, bh], dim=-1)
    n = s * s * 3
    return (boxes.reshape(b, n, 4), obj.reshape(b, n),
            cls.reshape(b, n, num_classes))


def decode_all_heads(heads: Sequence[torch.Tensor],
                     anchor_groups: np.ndarray, img_size: Tuple[int, int],
                     num_classes: int = 15):
    """Decode + concat all heads -> (boxes [B,N,4], obj [B,N], cls
    [B,N,C]), N = 3*(S1^2+S2^2+S3^2) (= 22743 at 608^2)."""
    outs = [decode_head(h, anchor_groups[i], img_size, num_classes)
            for i, h in enumerate(heads)]
    boxes = torch.cat([o[0] for o in outs], dim=1)
    obj = torch.cat([o[1] for o in outs], dim=1)
    cls = torch.cat([o[2] for o in outs], dim=1)
    return boxes, obj, cls


def head_cell_scores(head: torch.Tensor, num_classes: int = 15):
    """Raw per-cell (obj, cls) logits in anchor-major layout
    [B, S, S, 3], [B, S, S, 3, C] (no decode, no sigmoid)."""
    b, s = head.shape[:2]
    x = head.reshape(b, s, s, 3, 5 + num_classes)
    return x[..., 4], x[..., 5:]
