"""Evaluation statistics: per-class AP, precision/recall, TP accounting.

The port's copy of the reference package's ``ops/metrics.py:22-104``:
host numpy, offline analysis code.  Parity targets in
the reference's ``utils/utils.py``:

* :func:`get_batch_statistics` (``:154-190``) — greedy TP marking in model
  output order, one GT per detection, +1-pixel IoU convention;
* :func:`ap_per_class` (``:71-123``) — VOC-style AP per class from
  objectness-sorted detections;
* :func:`compute_ap` (``:126-151``) — precision-envelope integration.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .boxes import bbox_iou_np


def get_batch_statistics(
    outputs: Sequence, targets: np.ndarray, iou_threshold: float
) -> List[List[np.ndarray]]:
    """Per-sample (TP flags, scores, labels) triples.

    ``outputs`` is the ragged per-image detection list (rows
    ``x1,y1,x2,y2,conf,cls_conf,cls_pred``); ``targets`` is (T, 6) rows
    ``(sample_idx, class, x1, y1, x2, y2)`` in model-input pixel space.
    """
    batch_metrics: List[List[np.ndarray]] = []
    for sample_i in range(len(outputs)):
        if outputs[sample_i] is None:
            continue
        output = np.asarray(outputs[sample_i])
        pred_boxes = output[:, :4]
        pred_scores = output[:, 4]
        pred_labels = output[:, -1]

        true_positives = np.zeros(pred_boxes.shape[0])
        annotations = targets[targets[:, 0] == sample_i][:, 1:]
        target_labels = annotations[:, 0] if len(annotations) else []
        if len(annotations):
            detected: List[int] = []
            target_boxes = annotations[:, 1:]
            for pred_i, (pred_box, pred_label) in enumerate(zip(pred_boxes, pred_labels)):
                if len(detected) == len(annotations):
                    break
                if pred_label not in target_labels:
                    continue
                ious = bbox_iou_np(pred_box[None, :], target_boxes)
                box_index = int(np.argmax(ious))
                if ious[box_index] >= iou_threshold and box_index not in detected:
                    true_positives[pred_i] = 1
                    detected.append(box_index)
        batch_metrics.append([true_positives, pred_scores, pred_labels])
    return batch_metrics


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Area under the monotone precision envelope (``utils/utils.py:126-151``)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def ap_per_class(
    tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: Sequence
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-class precision, recall, AP, F1 (``utils/utils.py:71-123``)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    target_cls = np.asarray(target_cls)
    unique_classes = np.unique(target_cls)

    ap, p, r = [], [], []
    for c in unique_classes:
        sel = pred_cls == c
        n_gt = int((target_cls == c).sum())
        n_p = int(sel.sum())
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            ap.append(0.0)
            r.append(0.0)
            p.append(0.0)
        else:
            fpc = (1 - tp[sel]).cumsum()
            tpc = tp[sel].cumsum()
            recall_curve = tpc / (n_gt + 1e-16)
            precision_curve = tpc / (tpc + fpc)
            r.append(recall_curve[-1])
            p.append(precision_curve[-1])
            ap.append(compute_ap(recall_curve, precision_curve))

    p_a, r_a, ap_a = np.array(p), np.array(r), np.array(ap)
    f1 = 2 * p_a * r_a / (p_a + r_a + 1e-16)
    return p_a, r_a, ap_a, f1, unique_classes.astype("int32")


__all__ = ["get_batch_statistics", "compute_ap", "ap_per_class"]
