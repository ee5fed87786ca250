"""Offline analysis of a predictions directory, the counterpart of
`objectpermanence_tpu/analysis/offline.py` (the CLI's `analysis` mode):
overall and masked IoU and mAP aggregations, written as one CSV."""

from typing import List, Optional

import numpy as np

from objectpermanence_tpu_torch.analysis.analyzer import ResultsAnalyzer


def cal_map(x: np.ndarray):
    """The share of frames whose overlap passed the threshold."""
    return x.sum() / x.shape[0]


def analyze_results(predictions_dir: str, labels_dir: str, output_file: str,
                    containment_annotations: Optional[str] = None,
                    containment_only_static: Optional[str] = None,
                    containment_with_movements: Optional[str] = None,
                    visibility_gt_0: Optional[str] = None,
                    visibility_gt_30: Optional[str] = None,
                    visibility_gt_99: Optional[str] = None,
                    iou_thresh: Optional[List[float]] = None) -> ResultsAnalyzer:
    """IoU (mean) and mAP (`cal_map`) over all frames, then over each
    annotation file's frames given; with both the visibility and the
    containment files, also over the fully occluded frames: neither visible
    nor contained."""
    analyzer = ResultsAnalyzer.init_from_files(predictions_dir, labels_dir, iou_thresh)

    containment_mask = None
    for metric, agg_fn in zip(["iou", "map"], [np.mean, cal_map]):
        analyzer.compute_aggregated_metric("overall", agg_fn, metric=metric)

        if containment_annotations is not None:
            containment_mask = analyzer.frames_mask(containment_annotations)
            analyzer.compute_aggregated_metric_masking_frames(
                "contained", agg_fn, containment_mask, metric=metric)

        if containment_only_static is not None:
            analyzer.compute_aggregated_metric_masking_frames(
                "static_contained", agg_fn, analyzer.frames_mask(containment_only_static),
                metric=metric)

        if containment_with_movements is not None:
            analyzer.compute_aggregated_metric_masking_frames(
                "contained_with_move", agg_fn, analyzer.frames_mask(containment_with_movements),
                metric=metric)

        if visibility_gt_0 is not None:
            visibility_mask = analyzer.frames_mask(visibility_gt_0)
            analyzer.compute_aggregated_metric_masking_frames(
                "visibility_gt_0", agg_fn, visibility_mask, metric=metric)
            if containment_annotations is not None:
                full_occlusion = {video: np.logical_and(~mask, ~containment_mask[video])
                                  for video, mask in visibility_mask.items()}
                analyzer.compute_aggregated_metric_masking_frames(
                    "full_occlusion", agg_fn, full_occlusion, metric=metric)

        if visibility_gt_30 is not None:
            analyzer.compute_aggregated_metric_masking_frames(
                "visibility_gt_30", agg_fn, analyzer.frames_mask(visibility_gt_30),
                metric=metric)

        if visibility_gt_99 is not None:
            analyzer.compute_aggregated_metric_masking_frames(
                "visibility_gt_99", agg_fn, analyzer.frames_mask(visibility_gt_99),
                metric=metric)

    analyzer.write_results(output_file)
    return analyzer
