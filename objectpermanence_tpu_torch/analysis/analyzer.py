"""The IoU analyzer, the counterpart of
`objectpermanence_tpu/analysis/analyzer.py`: prediction files, ground-truth
and frame-mask parsing, and `ResultsAnalyzer`, per-video IoU and
thresholded-overlap metrics with masked aggregations, written as the same
CSV (the same columns, rounding and float formatting).

Host code, numpy and pandas only: the IoU is float64 numpy with the
reference's +1 area convention, as the JAX package computes it here.

Column names:
- `{agg_name}_{metric}` for unmasked aggregations (`overall_iou`,
  `overall_map_0.5`);
- `{agg_name}_mean_{metric}` and `{agg_name}_ratio` for masked IoU;
- `{agg_name}_mean_map_{thresh}` for masked mAP.
"""

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from objectpermanence_tpu_torch.vocab import SNITCH_TRACK_NAME

DEFECT_SENTINEL = -100  # the reference skips videos holding this marker


def iou_xyxy(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Elementwise IoU of two (..., 4) xyxy box arrays, +1 area convention."""
    xa = np.maximum(boxes_a[..., 0], boxes_b[..., 0])
    ya = np.maximum(boxes_a[..., 1], boxes_b[..., 1])
    xb = np.minimum(boxes_a[..., 2], boxes_b[..., 2])
    yb = np.minimum(boxes_a[..., 3], boxes_b[..., 3])
    inter = np.maximum(xb - xa + 1, 0) * np.maximum(yb - ya + 1, 0)
    area_a = (boxes_a[..., 2] - boxes_a[..., 0] + 1) * (boxes_a[..., 3] - boxes_a[..., 1] + 1)
    area_b = (boxes_b[..., 2] - boxes_b[..., 0] + 1) * (boxes_b[..., 3] - boxes_b[..., 1] + 1)
    return inter / (area_a + area_b - inter)


def parse_gt_bb_json(path) -> np.ndarray:
    """Ground-truth `<name>_bb.json` -> (T, 4) float64 xyxy snitch boxes
    (its tracks hold `[x, y, w, h]`)."""
    with open(path) as f:
        tracks = json.load(f)
    raw = np.asarray(tracks[SNITCH_TRACK_NAME], dtype=np.float64)
    return np.stack([raw[:, 0], raw[:, 1], raw[:, 0] + raw[:, 2], raw[:, 1] + raw[:, 3]],
                    axis=-1)


def write_bb_predictions(video_name: str, predictions_dir, boxes) -> Path:
    """Write `<name>_bb.json`: a list of int `[x1, y1, x2, y2]`, one per
    frame. Written to a temporary file and renamed, so a crash never leaves
    a truncated file."""
    path = Path(predictions_dir) / f"{video_name}_bb.json"
    data = [[int(x1), int(y1), int(x2), int(y2)] for x1, y1, x2, y2 in np.asarray(boxes)]
    tmp = path.with_suffix(".json.tmp")
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2)
    tmp.replace(path)
    return path


def parse_frames_mask_file(path, video_names: Sequence[str],
                           video_lengths: Dict[str, int]) -> Dict[str, np.ndarray]:
    """A tab-separated annotation file (`<video>\\t<frame>,<frame>,...`) ->
    boolean frame masks of the named videos."""
    wanted = set(video_names)
    masks = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            name, frames_str = line.split("\t")
            if name not in wanted:
                continue
            mask = np.zeros(video_lengths[name], dtype=bool)
            if frames_str:
                mask[np.array(frames_str.split(","), dtype=np.int64)] = True
            masks[name] = mask
    return masks


class ResultsAnalyzer:
    """IoU of every video and frame in one array; each aggregation is a
    reduction of its rows, over all frames or over a frame mask."""

    def __init__(self, video_names: List[str], predictions: np.ndarray, labels: np.ndarray,
                 iou_thresholds: Optional[List[float]] = None):
        predictions = np.asarray(predictions, dtype=np.float64)
        labels = np.asarray(labels, dtype=np.float64)
        assert len(video_names) == len(predictions) == len(labels)
        keep = ~np.any(predictions == DEFECT_SENTINEL, axis=(1, 2))
        self.video_names = [n for n, k in zip(video_names, keep) if k]
        self.predictions = predictions[keep]
        self.labels = labels[keep]
        self.iou_thresholds = iou_thresholds or []
        self.iou = iou_xyxy(self.predictions, self.labels)                 # (V, T)
        self.overlap = {t: self.iou > t for t in self.iou_thresholds}
        self.metrics: Dict[str, np.ndarray] = {}

    @classmethod
    def init_from_files(cls, predictions_dir, labels_dir,
                        iou_thresholds: Optional[List[float]] = None):
        """Pair each `<name>_bb.json` prediction with its ground truth; a
        prediction without one is skipped."""
        predictions_dir, labels_dir = Path(predictions_dir), Path(labels_dir)
        names, preds, gts = [], [], []
        for f_pred in sorted(predictions_dir.glob("*_bb.json")):
            name = f_pred.stem[:-3]
            gt_path = labels_dir / f"{name}_bb.json"
            if not gt_path.exists():
                continue
            with open(f_pred) as f:
                preds.append(np.asarray(json.load(f), dtype=np.float64))
            gts.append(parse_gt_bb_json(gt_path))
            names.append(name)
        return cls(names, np.stack(preds), np.stack(gts), iou_thresholds)

    @property
    def num_frames(self) -> int:
        return self.iou.shape[1]

    def video_lengths(self) -> Dict[str, int]:
        return {name: self.num_frames for name in self.video_names}

    def frames_mask(self, annotation_file) -> Dict[str, np.ndarray]:
        return parse_frames_mask_file(annotation_file, self.video_names, self.video_lengths())

    def _mask_matrix(self, masks: Dict[str, np.ndarray]) -> np.ndarray:
        return np.stack([masks.get(name, np.zeros(self.num_frames, dtype=bool))
                         for name in self.video_names])

    def compute_aggregated_metric(self, agg_name: str, agg_fn, metric: str = "iou") -> None:
        if metric == "iou":
            self.metrics[f"{agg_name}_{metric}"] = np.array([float(agg_fn(row))
                                                             for row in self.iou])
        elif metric == "map":
            for thresh, overlap in self.overlap.items():
                self.metrics[f"{agg_name}_{metric}_{thresh}"] = np.array(
                    [float(agg_fn(row)) for row in overlap])
        else:
            raise NotImplementedError(f"metric {metric!r} is not supported")

    def compute_aggregated_metric_masking_frames(self, agg_name: str, agg_fn,
                                                 masks: Dict[str, np.ndarray],
                                                 metric: str = "iou") -> None:
        """`agg_fn` over each video's masked frames; NaN where it has none."""
        mask = self._mask_matrix(masks)
        counts = mask.sum(axis=1)

        def masked_rows(values):
            return np.array([float(agg_fn(row[m])) if c else np.nan
                             for row, m, c in zip(values, mask, counts)])

        if metric == "iou":
            self.metrics[f"{agg_name}_mean_{metric}"] = masked_rows(self.iou)
            self.metrics[f"{agg_name}_ratio"] = np.where(counts > 0, counts / mask.shape[1], 0.0)
        elif metric == "map":
            for thresh, overlap in self.overlap.items():
                self.metrics[f"{agg_name}_mean_map_{thresh}"] = masked_rows(overlap)
        else:
            raise NotImplementedError(f"metric {metric!r} is not supported")

    def compute_precision_data(self, thresholds: Optional[List[float]] = None,
                               masks: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Precision at each IoU threshold (0, 0.05, ..., 0.95 by default)."""
        if thresholds is None:
            thresholds = [i / 20 for i in range(20)]
        for t in thresholds:
            def t_agg(x, _t=t):
                return np.sum(x > _t) / x.shape[0]
            if masks is not None:
                self.compute_aggregated_metric_masking_frames(f"occ_precision_{t}", t_agg, masks)
            else:
                self.compute_aggregated_metric(f"precision_{t}", t_agg)

    def get_analysis_df(self) -> pd.DataFrame:
        order = np.argsort(self.video_names)
        data = {"videos_names": [self.video_names[i] for i in order]}
        for name, values in self.metrics.items():
            data[name] = values[order]
        return pd.DataFrame(data)

    def write_results(self, path) -> None:
        self.get_analysis_df().round(3).to_csv(path, index=None)
