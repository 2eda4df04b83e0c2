"""Creation-attack metrics (the JAX package's ``evals/metrics.py``,
numpy on the host).

The paper's evaluation protocol (reference test_patch_DOTA_metrics.py:
301-377 and utils_self.py):

- **M1** average instances created: (len(pred) - len(gt)) / n_images,
  at conf 0.4 (5-col labels) and conf 0.01 (7-col labels);
- **M2** average confidence created: (sum obj_conf_pred - sum
  obj_conf_gt) / delta_instances;
- **M4** per-class instance gap at conf 0.01;
- precision/recall of predictions vs ground truth at IoU 0.5
  (utils_self.eval_list:12-67), and VOC-style AP from a PR curve
  (utils_self.ap_calculation:70-108).

All functions take either label dirs (file-based parity with the
reference) or in-memory lists of label arrays.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from ..data.labels import count_instances, read_label_file
from ..ops.nms import iou_xywh_matrix

Labels = Union[str, Sequence[np.ndarray]]


def _as_arrays(labels: Labels, ncols: int) -> List[np.ndarray]:
    if isinstance(labels, str):
        # infer width per file (5- and 7-col dirs coexist, and the
        # reference's parsers are token-wise)
        return [read_label_file(os.path.join(labels, n), None)
                for n in sorted(os.listdir(labels)) if n.endswith(".txt")]
    return list(labels)


def instance_count(labels: Labels, ncols: int = 7) -> int:
    if isinstance(labels, str):
        return count_instances(labels)[0]
    return sum(len(a) for a in _as_arrays(labels, ncols))


def conf_sum(labels: Labels, ncols: int = 7, conf_col: int = 4) -> float:
    """Sum of the objectness column over every row of every label file
    (utils_self.per_img_conf_sum parity)."""
    return float(sum(a[:, conf_col].sum()
                     for a in _as_arrays(labels, ncols) if len(a)))


def instances_per_class(labels: Labels, num_classes: int = 15,
                        ncols: int = 7) -> np.ndarray:
    """Per-class instance counts; class id is the last column
    (utils_self.instances_per_class_cal parity)."""
    counts = np.zeros(num_classes, dtype=np.int64)
    for a in _as_arrays(labels, ncols):
        for row in a:
            counts[int(row[-1])] += 1
    return counts


def m1_average_instances_created(pred: Labels, gt: Labels,
                                 n_images: int, ncols: int = 7) -> float:
    return (instance_count(pred, ncols) - instance_count(gt, ncols)) \
        / n_images


def m2_average_confidence_created(pred: Labels, gt: Labels,
                                  ncols: int = 7) -> float:
    gap = instance_count(pred, ncols) - instance_count(gt, ncols)
    if gap == 0:
        return float("nan")   # nothing created: M2 undefined
    return (conf_sum(pred, ncols) - conf_sum(gt, ncols)) / gap


def m4_per_class_gap(pred: Labels, gt: Labels, num_classes: int = 15,
                     ncols: int = 7) -> np.ndarray:
    return (instances_per_class(pred, num_classes, ncols)
            - instances_per_class(gt, num_classes, ncols))


def precision_recall(pred_labels: Labels, gt_labels: Labels,
                     conf_thresh: float, iou_thresh: float = 0.5
                     ) -> Tuple[float, float]:
    """Dataset-level precision/recall (utils_self.eval_list parity):
    predictions are 7-col rows counted as proposals when
    obj*cls_conf > conf_thresh; a GT box is matched if its best IoU over
    *all* predicted rows exceeds iou_thresh."""
    preds = _as_arrays(pred_labels, 7)
    gts = _as_arrays(gt_labels, 5)
    total = proposals = correct = 0.0
    for p, g in zip(preds, gts):
        total += len(g)
        if len(p):
            proposals += float((p[:, 4] * p[:, 5] > conf_thresh).sum())
        if len(g) and len(p):
            iou = iou_xywh_matrix(g[:, 1:5], p[:, 0:4])
            correct += float((iou.max(axis=1) > iou_thresh).sum())
    precision = correct / (proposals + 1e-8)
    recall = correct / (total + 1e-8)
    return precision, recall


def ap_from_pr(recall: np.ndarray, precision: np.ndarray,
               use_07_metric: bool = False) -> float:
    """VOC AP from a PR curve (utils_self.ap_calculation parity)."""
    recall = np.asarray(recall, dtype=np.float64)
    precision = np.asarray(precision, dtype=np.float64)
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def average_precision(pred_labels: Labels, gt_labels: Labels,
                      iou_thresh: float = 0.5,
                      class_id: int | None = None) -> float:
    """Ranked-detection AP (the "computed offline" mAP piece,
    test_patch_DOTA_metrics.py:338): sweep all 7-col predictions by
    descending obj*cls score, greedy-match to GT at iou_thresh, and
    integrate the PR curve with ``ap_from_pr``."""
    preds = _as_arrays(pred_labels, 7)
    gts = _as_arrays(gt_labels, 5)
    rows = []   # (score, img_idx, box)
    for i, p in enumerate(preds):
        for row in p:
            if class_id is None or int(row[6]) == class_id:
                rows.append((float(row[4] * row[5]), i, row[0:4]))
    rows.sort(key=lambda r: -r[0])
    gt_boxes = []
    for g in gts:
        if class_id is None:
            gt_boxes.append(g[:, 1:5] if len(g) else np.zeros((0, 4)))
        else:
            sel = g[g[:, 0] == class_id] if len(g) else g
            gt_boxes.append(sel[:, 1:5] if len(sel) else np.zeros((0, 4)))
    n_gt = sum(len(g) for g in gt_boxes)
    if n_gt == 0 or not rows:
        return 0.0
    matched = [np.zeros(len(g), bool) for g in gt_boxes]
    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    for k, (_, i, box) in enumerate(rows):
        g = gt_boxes[i]
        if len(g) == 0:
            fp[k] = 1
            continue
        iou = iou_xywh_matrix(box[None], g)[0]
        j = int(np.argmax(iou))
        if iou[j] > iou_thresh and not matched[i][j]:
            tp[k] = 1
            matched[i][j] = True
        else:
            fp[k] = 1
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    rec = ctp / n_gt
    prec = ctp / np.maximum(ctp + cfp, 1e-9)
    return ap_from_pr(rec, prec)


def mean_average_precision(pred_labels: Labels, gt_labels: Labels,
                           num_classes: int = 15,
                           iou_thresh: float = 0.5) -> float:
    aps = [average_precision(pred_labels, gt_labels, iou_thresh, c)
           for c in range(num_classes)]
    return float(np.mean(aps)) if aps else 0.0


def creation_metrics_report(pred_04: Labels, gt_04: Labels,
                            pred_001: Labels, gt_001: Labels,
                            n_images: int,
                            num_classes: int = 15) -> Dict[str, object]:
    """The full metric block printed by the reference
    (test_patch_DOTA_metrics.py:301-377)."""
    return {
        "M4_per_class_gap_001": m4_per_class_gap(
            pred_001, gt_001, num_classes).tolist(),
        "M1_avg_instances_created_04": m1_average_instances_created(
            pred_04, gt_04, n_images, ncols=5),
        "M1_avg_instances_created_001": m1_average_instances_created(
            pred_001, gt_001, n_images),
        "M2_avg_conf_created_001": m2_average_confidence_created(
            pred_001, gt_001),
        "instances_pred_04": instance_count(pred_04, 5),
        "instances_gt_04": instance_count(gt_04, 5),
        "instances_pred_001": instance_count(pred_001),
        "instances_gt_001": instance_count(gt_001),
        # quirk of record: the reference computes M2@0.4 by summing
        # column 4 of the 5-col label files — which is the box *height*
        # (per_img_conf_sum applied to conf-less labels,
        # test_patch_DOTA_metrics.py:367-371). Reported for parity.
        "M2_avg_conf_created_04_quirk": _m2_04_quirk(pred_04, gt_04),
    }


def _m2_04_quirk(pred_04: Labels, gt_04: Labels) -> float:
    gap = instance_count(pred_04, 5) - instance_count(gt_04, 5)
    if gap == 0:
        return float("nan")
    return (conf_sum(pred_04, 5) - conf_sum(gt_04, 5)) / gap
