"""Detection path: image -> 3 raw heads -> decode -> threshold -> NMS.

The ``do_detect`` contract (reference utils.py:450-519): forward, decode
each head with the (quirk-paired) anchor group, keep boxes with
obj*cls_max > conf_thresh, greedy-NMS at nms_thresh ranked by obj; each
detection is the 7-tuple ``[x, y, w, h, obj, cls_conf, cls_id]``
(normalized xywh).

Decode and the top-k prune run on the device as one batched pass over
all candidates. ``detect_batch`` brings the pruned set to the host for
the exact greedy NMS; ``detect_batch_device`` (the serving path) runs
the NMS on the device too. On CUDA the detector asks for both stem
kernels, as the JAX package's does on the TPU: the fused stem where the
YOLOv3 widths allow it, else the per-layer planar stem (K4, e.g. the slim
victim's narrow stem), else the conv walk; ``res152`` picks a kernel
route for layers 6-11 after a kernel stem ("c12": layers 0-12 on the
planar-out fused stem, K6a and conv12, where it applies).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..data.assets import load_anchor_groups
from ..models.darknet import Darknet, Network, Params
from ..ops import _cuda
from ..ops.decode import decode_all_heads
from ..ops.nms import greedy_nms_device_batch, greedy_nms_host

MAX_CANDIDATES = 4096  # pre-NMS cap; conf 0.01 sweeps can be wide
MAX_DET = 300          # device NMS slots (the reference's merge-NMS cap)


def _topk_stable(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, ties to the
    lower index (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(score, dim=-1, descending=True,
                      stable=True).indices[..., :k]


class Detector:
    """Victim-detector inference on one device (``"cuda"`` by default;
    raises if that device is missing)."""

    def __init__(self, net: Network, params: Params,
                 anchor_groups: Optional[np.ndarray] = None,
                 img_size: int = 608, num_classes: int = 15,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 max_candidates: int = MAX_CANDIDATES, device="cuda",
                 res152: Optional[str] = None):
        self.device = _cuda.resolve_device(device)
        self.net = net
        self.img_size = img_size
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        self.anchor_groups = (anchor_groups if anchor_groups is not None
                              else load_anchor_groups())
        self.max_candidates = max_candidates
        self.params = params
        self.model = Darknet(net, params, compute_dtype,
                             device=self.device).eval()
        # forward_heads' float32 model, built at its first call
        self._model32: Optional[Darknet] = None
        # inference is forward-only: the stem kernels are taken on the
        # card, fused first, then planar (the model takes the conv walk
        # where neither geometry matches)
        self.fused_stem = self.planar_stem = self.device.type == "cuda"
        self.res152 = res152

    def _heads(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.model(x, fused_stem=self.fused_stem,
                          planar_stem=self.planar_stem, res152=self.res152)

    def _to_device(self, images) -> torch.Tensor:
        if isinstance(images, torch.Tensor):
            return images.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(images)).to(
            self.device)

    def _fields(self, x: torch.Tensor):
        heads = self._heads(x)
        boxes, obj, cls = decode_all_heads(
            heads, self.anchor_groups, (self.img_size, self.img_size),
            self.num_classes)
        cls_conf = torch.amax(cls, dim=-1)
        cls_id = torch.argmax(cls, dim=-1).to(boxes.dtype)
        return boxes, obj, cls_conf, cls_id

    def _decode_fields(self, x: torch.Tensor) -> torch.Tensor:
        """All candidates as 8-float rows [B, N, 8]:
        (x, y, w, h, obj, cls_conf, cls_id, obj*cls_conf)."""
        boxes, obj, cls_conf, cls_id = self._fields(x)
        return torch.cat([boxes, obj[..., None], cls_conf[..., None],
                          cls_id[..., None], (obj * cls_conf)[..., None]],
                         dim=-1)

    @torch.inference_mode()
    def _infer(self, x: torch.Tensor) -> torch.Tensor:
        """Top-``max_candidates`` rows by score, pruned on the device."""
        vals = self._decode_fields(x)
        k = min(self.max_candidates, vals.shape[1])
        top_idx = _topk_stable(vals[..., 7], k)
        return torch.gather(vals, 1, top_idx[..., None].expand(-1, -1, 8))

    @torch.inference_mode()
    def _infer_full(self, x: torch.Tensor) -> torch.Tensor:
        """Every candidate row (the un-pruned fallback)."""
        return self._decode_fields(x)

    @torch.inference_mode()
    def forward_heads(self, images) -> List[torch.Tensor]:
        """Raw heads (NHWC) for a [B, S, S, 3] batch, computed in float32
        whatever the detector's compute dtype, as the JAX package's
        ``forward_heads`` (``darknet.apply`` at its float32 default): a
        float32 copy of the model on the conv walk (whose float32 forward
        runs with TF32 off, ``ops/_cuda.no_tf32``)."""
        if self._model32 is None:
            self._model32 = (self.model if self.compute_dtype == torch.float32
                             else Darknet(self.net, self.params, torch.float32,
                                          device=self.device).eval())
        return self._model32(self._to_device(images).to(torch.float32))

    def detect_batch(self, images, conf_thresh: float,
                     nms_thresh: float) -> List[np.ndarray]:
        """Detect on a [B, S, S, 3] float batch. Returns per-image [N, 7]
        arrays (x, y, w, h, obj, cls_conf, cls_id), NMS'd, normalized."""
        x = self._to_device(images)
        vals = self._infer(x).cpu().numpy()
        score = vals[..., 7]
        n_pruned = score.shape[1]
        # the pruned set keeps the top `max_candidates` by score; if
        # every pruned row of some image clears conf_thresh there may be
        # more survivors beyond the cut — redo with the full candidate
        # set (exact, just more host traffic) instead of truncating.
        saturated = np.all(score > conf_thresh, axis=1) & (
            n_pruned == self.max_candidates)
        if saturated.any():
            vals = self._infer_full(x).cpu().numpy()
            score = vals[..., 7]
        results = []
        for i in range(vals.shape[0]):
            keep = score[i] > conf_thresh
            boxes = vals[i, keep, 0:4]
            obj = vals[i, keep, 4]
            cls_conf = vals[i, keep, 5]
            cls_id = vals[i, keep, 6]
            # reference NMS sorts by obj conf (utils.py:99)
            kept = greedy_nms_host(boxes, obj, nms_thresh)
            det = np.concatenate([
                boxes[kept], obj[kept, None], cls_conf[kept, None],
                cls_id[kept, None].astype(np.float32)], axis=1)
            results.append(det.astype(np.float32))
        return results

    def detect(self, image, conf_thresh: float,
               nms_thresh: float) -> np.ndarray:
        """Single image [S, S, 3] -> [N, 7] detections."""
        return self.detect_batch(np.asarray(image)[None], conf_thresh,
                                 nms_thresh)[0]

    @torch.inference_mode()
    def detect_batch_device(self, images, conf_thresh: float,
                            nms_thresh: float):
        """Detection fully on the device: forward + decode + threshold +
        greedy NMS. Returns fixed-size device tensors
        (dets [B, 300, 7], valid [B, 300], saturated [B] bool) — the
        serving path; semantics match ``detect_batch`` (NMS ranked by
        obj, candidates thresholded on obj*cls). A uint8 batch is
        normalized on the device (4x less host->device traffic).

        Pruning contract: NMS runs over the top 2,400 (= 8*300)
        candidates per image. ``saturated[b]`` is True iff image b had
        MORE above-threshold candidates than that, the only case where
        results can be incomplete; ``detect_batch`` is always exact."""
        x = self._to_device(images)
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        boxes, obj, cls_conf, cls_id = self._fields(x)
        # candidates pass obj*cls > conf; NMS ranks by obj
        nms_score = torch.where(obj * cls_conf > conf_thresh, obj,
                                torch.zeros_like(obj))
        idx, valid, saturated = greedy_nms_device_batch(
            boxes, nms_score, nms_thresh, max_det=MAX_DET)
        rows = torch.cat([boxes, obj[..., None], cls_conf[..., None],
                          cls_id[..., None]], dim=-1)
        dets = torch.gather(rows, 1, idx[..., None].expand(-1, -1, 7))
        dets = torch.where(valid[..., None], dets, torch.zeros_like(dets))
        return dets, valid, saturated


def detections_to_label_rows(dets: np.ndarray, with_conf: bool = True
                             ) -> np.ndarray:
    """7-col rows as-is, or 5-col ``cls x y w h`` training rows."""
    if with_conf:
        return dets
    return np.concatenate([dets[:, 6:7], dets[:, 0:4]], axis=1)
