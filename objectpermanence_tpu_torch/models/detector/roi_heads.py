"""RoI heads, the counterpart of
`objectpermanence_tpu/models/detector/roi_heads.py`: FPN level assignment,
the two-MLP box head and per-class postprocessing with padded static
shapes. Names as torchvision's `roi_heads.box_head` (`fc6`, `fc7`) and
`roi_heads.box_predictor` (`cls_score`, `bbox_pred`)."""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from objectpermanence_tpu_torch.models.detector.boxcoder import (
    ROI_WEIGHTS, clip_to_image, decode,
)
from objectpermanence_tpu_torch.ops.nms import NEG_INF, batched_class_nms, top_k_by_score

# FPN levels P2..P5 used for RoI pooling, with strides 4..32
ROI_STRIDES = (4, 8, 16, 32)


def assign_levels(rois: torch.Tensor, k_min: int = 2, k_max: int = 5) -> torch.Tensor:
    """FPN paper heuristic in float32: k = floor(4 + log2(sqrt(area)/224)),
    clamped to [k_min, k_max]; rois (..., 4) -> 0-based int32 level index
    into P2..P5."""
    area = ((rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])).clamp(min=1e-6)
    k = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-6))
    return (k.clamp(k_min, k_max) - k_min).to(torch.int32)


class Linear(nn.Linear):
    """`nn.Linear` in its input's dtype (parameters stay float32 masters)."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class TwoMLPHead(nn.Module):
    def __init__(self, in_dim: int, representation: int = 1024):
        super().__init__()
        self.fc6 = Linear(in_dim, representation)
        self.fc7 = Linear(representation, representation)

    def forward(self, x):
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class FastRCNNPredictor(nn.Module):
    def __init__(self, representation: int = 1024, num_classes: int = 193):
        super().__init__()
        self.cls_score = Linear(representation, num_classes)
        self.bbox_pred = Linear(representation, num_classes * 4)


class RoIHeads(nn.Module):
    def __init__(self, in_channels: int = 256, pooled: int = 7, representation: int = 1024,
                 num_classes: int = 193):
        super().__init__()
        self.box_head = TwoMLPHead(in_channels * pooled * pooled, representation)
        self.box_predictor = FastRCNNPredictor(representation, num_classes)

    def forward(self, roi_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """roi_features (..., C, p, p) -> (cls_logits (..., K), box_deltas
        (..., K, 4)). The flatten is C-major, torch's (N, C, 7, 7) order,
        so fc6's columns line up with torchvision's and the JAX package's.
        Runs in the features' dtype and emits float32, for the decode, the
        scores and the losses."""
        lead = roi_features.shape[:-3]
        x = self.box_head(roi_features.reshape(*lead, -1))
        cls_logits = self.box_predictor.cls_score(x).float()
        box_deltas = self.box_predictor.bbox_pred(x).float()
        return cls_logits, box_deltas.reshape(*lead, -1, 4)


def postprocess_detections(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
                           proposals: torch.Tensor, proposal_scores: torch.Tensor,
                           image_hw: Tuple[int, int], score_thresh: float = 0.05,
                           nms_thresh: float = 0.5, detections_per_img: int = 100,
                           pre_nms_candidates: int = 1000):
    """Batched over images: cls_logits (B, N, K), box_deltas (B, N, K, 4),
    proposals (B, N, 4), proposal_scores (B, N) -> (boxes (B, D, 4), labels
    (B, D), scores (B, D)) with NEG_INF score padding. Class 0 is background
    and never predicted (the reference's 193 classes include it)."""
    height, width = image_hw
    batch, _, num_classes = cls_logits.shape
    probs = torch.softmax(cls_logits, dim=-1)
    boxes = clip_to_image(decode(proposals[..., None, :], box_deltas, ROI_WEIGHTS),
                          height, width)                                # (B, N, K, 4)

    # drop the background column; flatten N-major
    probs = probs[..., 1:]
    boxes = boxes[..., 1:, :]
    labels = torch.arange(1, num_classes, device=probs.device).expand(probs.shape)

    # mask padding proposals and low scores
    valid_prop = proposal_scores > NEG_INF / 10
    flat_scores = torch.where(valid_prop[..., None], probs, NEG_INF).reshape(batch, -1)
    flat_scores = torch.where(flat_scores >= score_thresh, flat_scores, NEG_INF)
    flat_boxes = boxes.reshape(batch, -1, 4)
    flat_labels = labels.reshape(batch, -1)

    # remove tiny boxes (torchvision min_size 1e-2)
    ws = flat_boxes[..., 2] - flat_boxes[..., 0]
    hs = flat_boxes[..., 3] - flat_boxes[..., 1]
    flat_scores = torch.where((ws >= 1e-2) & (hs >= 1e-2), flat_scores, NEG_INF)

    cand_boxes, cand_scores, cand_labels = top_k_by_score(
        flat_boxes, flat_scores, pre_nms_candidates, flat_labels)
    keep = batched_class_nms(cand_boxes, cand_scores, cand_labels, nms_thresh)
    cand_scores = torch.where(keep, cand_scores, NEG_INF)
    det_boxes, det_scores, det_labels = top_k_by_score(
        cand_boxes, cand_scores, detections_per_img, cand_labels)
    return det_boxes, det_labels, det_scores
