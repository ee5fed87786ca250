"""COCO-style detection metrics in numpy, the port's copy of
`objectpermanence_tpu/analysis/detection_eval.py`.

Per-class AP over IoU thresholds 0.5:0.95:0.05 with 101-point interpolated
precision, plus AP50 and AP75: the numbers the reference's evaluator prints
each epoch, without pycocotools.
"""

from typing import Dict, List

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    xa = np.maximum(a[:, None, 0], b[None, :, 0])
    ya = np.maximum(a[:, None, 1], b[None, :, 1])
    xb = np.minimum(a[:, None, 2], b[None, :, 2])
    yb = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(xb - xa, 0, None) * np.clip(yb - ya, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _average_precision(scores, matched, num_gt) -> np.ndarray:
    """101-point interpolated AP per IoU threshold.
    scores (D,), matched (T, D) bool, num_gt scalar."""
    if num_gt == 0:
        return np.full(len(IOU_THRESHOLDS), np.nan)
    if len(scores) == 0:
        return np.zeros(len(IOU_THRESHOLDS))
    order = np.argsort(-scores, kind="stable")
    matched = matched[:, order]
    tp = np.cumsum(matched, axis=1)
    fp = np.cumsum(~matched, axis=1)
    recall = tp / num_gt
    precision = tp / np.maximum(tp + fp, 1)

    aps = np.zeros(len(IOU_THRESHOLDS))
    recall_points = np.linspace(0, 1, 101)
    for t in range(len(IOU_THRESHOLDS)):
        # precision envelope (monotone non-increasing from the right)
        prec = np.maximum.accumulate(precision[t][::-1])[::-1]
        idx = np.searchsorted(recall[t], recall_points, side="left")
        p = np.where(idx < len(prec), prec[np.minimum(idx, len(prec) - 1)], 0.0)
        aps[t] = p.mean()
    return aps


def _match(p_boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """Greedy matching per threshold, detections in descending score order:
    each takes the untaken ground truth of highest IoU at or above the
    threshold (the last of equals). -> matched (T, D) bool."""
    matched = np.zeros((len(IOU_THRESHOLDS), len(p_boxes)), bool)
    if not (len(p_boxes) and len(gt_boxes)):
        return matched
    iou = _iou_matrix(p_boxes, gt_boxes)
    for t, thresh in enumerate(IOU_THRESHOLDS):
        taken = np.zeros(len(gt_boxes), bool)
        for d in range(len(p_boxes)):
            best, best_iou = -1, thresh
            for g in range(len(gt_boxes)):
                if not taken[g] and iou[d, g] >= best_iou:
                    best, best_iou = g, iou[d, g]
            if best >= 0:
                taken[best] = True
                matched[t, d] = True
    return matched


def evaluate_detections(predictions: List[Dict], ground_truths: List[Dict]) -> Dict[str, float]:
    """predictions[i] = {"boxes" (D, 4), "labels" (D,), "scores" (D,)};
    ground_truths[i] = {"boxes" (G, 4), "labels" (G,)}: numpy, one entry per
    image, already filtered to valid rows. -> {"mAP", "AP50", "AP75"}."""
    classes = sorted({int(label) for gt in ground_truths for label in gt["labels"]})
    per_class_aps = []
    for cls in classes:
        scores_all, matched_all, num_gt = [], [], 0
        for pred, gt in zip(predictions, ground_truths):
            gt_boxes = gt["boxes"][gt["labels"] == cls]
            num_gt += len(gt_boxes)
            p_mask = pred["labels"] == cls
            p_boxes, p_scores = pred["boxes"][p_mask], pred["scores"][p_mask]
            order = np.argsort(-p_scores, kind="stable")
            p_boxes, p_scores = p_boxes[order], p_scores[order]
            scores_all.append(p_scores)
            matched_all.append(_match(p_boxes, gt_boxes))
        scores_cat = np.concatenate(scores_all) if scores_all else np.zeros(0)
        matched_cat = (np.concatenate(matched_all, axis=1)
                       if matched_all else np.zeros((len(IOU_THRESHOLDS), 0), bool))
        per_class_aps.append(_average_precision(scores_cat, matched_cat, num_gt))

    aps = np.asarray(per_class_aps)  # (C, T)
    with np.errstate(invalid="ignore"):
        mean_aps = np.nanmean(aps, axis=0) if len(aps) else np.zeros(len(IOU_THRESHOLDS))
    return {
        "mAP": float(np.nanmean(mean_aps)),
        "AP50": float(mean_aps[0]),
        "AP75": float(mean_aps[5]),
    }
