"""Single-object tracker benchmark (OTB-style one-pass evaluation), the
counterpart of `objectpermanence_tpu/analysis/tracker_eval.py`. Host numpy.

The reference's vendored DaSiamRPN harness (`baselines/DaSiamRPN/code/
test_otb.py`, `eval_otb.py`): run a tracker over annotated sequences from
the first frame's ground truth, then score success (the AUC of the IoU
threshold curve) and precision (the centre-error threshold curve), the OTB
OPE metrics. Any tracker with `init(frame, pos, sz)` and `track(state,
frame)` (its state has `pos` and `sz`) plugs in, `models/siam.py`'s
`SiamRPNTracker` among them.
"""

from typing import Callable, Dict, List, Sequence

import numpy as np


def run_tracker_on_sequence(tracker, frames: Sequence[np.ndarray],
                            init_box_xywh) -> np.ndarray:
    """One-pass evaluation: init on frame 0's GT, track the rest.
    Returns (T, 4) xywh predictions (frame 0 echoes the init box)."""
    x, y, w, h = init_box_xywh
    state = tracker.init(frames[0], np.array([x + w / 2, y + h / 2]),
                         np.array([w, h], dtype=np.float64))
    boxes = [list(init_box_xywh)]
    for frame in frames[1:]:
        state = tracker.track(state, frame)
        cx, cy = state.pos
        tw, th = state.sz
        boxes.append([cx - tw / 2, cy - th / 2, tw, th])
    return np.asarray(boxes, dtype=np.float64)


def success_overlap(gt_xywh: np.ndarray, pred_xywh: np.ndarray) -> np.ndarray:
    """Per-frame IoU (zero-area convention, as OTB)."""
    gx1, gy1 = gt_xywh[:, 0], gt_xywh[:, 1]
    gx2, gy2 = gx1 + gt_xywh[:, 2], gy1 + gt_xywh[:, 3]
    px1, py1 = pred_xywh[:, 0], pred_xywh[:, 1]
    px2, py2 = px1 + pred_xywh[:, 2], py1 + pred_xywh[:, 3]
    ix = np.clip(np.minimum(gx2, px2) - np.maximum(gx1, px1), 0, None)
    iy = np.clip(np.minimum(gy2, py2) - np.maximum(gy1, py1), 0, None)
    inter = ix * iy
    union = (gt_xywh[:, 2] * gt_xywh[:, 3] + pred_xywh[:, 2] * pred_xywh[:, 3]
             - inter)
    return np.where(union > 0, inter / union, 0.0)


def center_error(gt_xywh: np.ndarray, pred_xywh: np.ndarray) -> np.ndarray:
    gc = gt_xywh[:, :2] + gt_xywh[:, 2:] / 2
    pc = pred_xywh[:, :2] + pred_xywh[:, 2:] / 2
    return np.linalg.norm(gc - pc, axis=1)


def ope_metrics(gt_xywh: np.ndarray, pred_xywh: np.ndarray) -> Dict[str, float]:
    """OTB OPE scores: success AUC over IoU thresholds 0..1 (21 points) and
    precision at the 20-pixel center-error threshold."""
    iou = success_overlap(gt_xywh, pred_xywh)
    thresholds = np.linspace(0, 1, 21)
    success = np.array([(iou > t).mean() for t in thresholds])
    errors = center_error(gt_xywh, pred_xywh)
    return {
        "success_auc": float(success.mean()),
        "precision_20px": float((errors <= 20).mean()),
        "mean_iou": float(iou.mean()),
    }


def evaluate_tracker(tracker, sequences: List[Dict]) -> Dict[str, float]:
    """sequences: [{"frames": [ndarray], "gt": (T, 4) xywh}] ->
    averaged OPE metrics + per-sequence breakdown."""
    per_seq = []
    for seq in sequences:
        gt = np.asarray(seq["gt"], dtype=np.float64)
        pred = run_tracker_on_sequence(tracker, seq["frames"], gt[0])
        per_seq.append(ope_metrics(gt, pred))
    averaged = {key: float(np.mean([m[key] for m in per_seq]))
                for key in per_seq[0]}
    averaged["per_sequence"] = per_seq
    return averaged
