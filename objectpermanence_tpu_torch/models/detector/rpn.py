"""Region Proposal Network, the counterpart of
`objectpermanence_tpu/models/detector/rpn.py`: a shared conv head over the
pyramid, then padded static-shape proposal selection (per-level top-k ->
decode -> clip -> per-level NMS -> global top-k). Head names as
torchvision's `rpn.head` in its <=0.5 layout."""

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from objectpermanence_tpu_torch.models.detector.boxcoder import (
    RPN_WEIGHTS, clip_to_image, decode,
)
from objectpermanence_tpu_torch.models.detector.resnet import conv
from objectpermanence_tpu_torch.ops.nms import NEG_INF, nms_mask, top_k_by_score


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = conv(in_channels, in_channels, 3, bias=True)
        self.cls_logits = conv(in_channels, num_anchors, 1, bias=True)
        self.bbox_pred = conv(in_channels, num_anchors * 4, 1, bias=True)

    def forward(self, features: List[torch.Tensor]) -> Tuple[List[torch.Tensor],
                                                             List[torch.Tensor]]:
        """Per level: objectness (B, H*W*A) and deltas (B, H*W*A, 4), in the
        JAX package's cell-major, then anchor, order. Runs in the features'
        dtype and emits float32, for the box decode and the scores."""
        objectness, deltas = [], []
        for feat in features:
            t = F.relu(self.conv(feat))
            cls = self.cls_logits(t).permute(0, 2, 3, 1)         # (B, H, W, A)
            reg = self.bbox_pred(t).permute(0, 2, 3, 1)          # (B, H, W, A*4)
            b = cls.shape[0]
            objectness.append(cls.reshape(b, -1).float())
            deltas.append(reg.reshape(b, -1, 4).float())
        return objectness, deltas


def generate_proposals(objectness: List[torch.Tensor], deltas: List[torch.Tensor],
                       anchors: List[torch.Tensor], image_hw: Tuple[int, int],
                       pre_nms_top_n: int, post_nms_top_n: int, nms_thresh: float = 0.7,
                       min_size: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level scores (B, n_l) (after the sigmoid) and deltas (B, n_l, 4)
    -> (proposals (B, post, 4), scores (B, post)); padding entries carry
    NEG_INF scores. The per-level NMS runs once over every (image, level)
    pair: each level's k candidates are padded with NEG_INF to the largest
    k, and padding neither survives nor suppresses."""
    height, width = image_hw
    boxes_all, scores_all = [], []
    for scores, dts, anch in zip(objectness, deltas, anchors):
        k = min(pre_nms_top_n, scores.shape[1])
        boxes, top_scores, top_deltas = top_k_by_score(
            anch.expand(scores.shape[0], -1, -1), scores, k, dts)
        boxes = clip_to_image(decode(boxes, top_deltas, RPN_WEIGHTS), height, width)
        # drop degenerate boxes
        ws = boxes[..., 2] - boxes[..., 0]
        hs = boxes[..., 3] - boxes[..., 1]
        valid = (ws >= min_size) & (hs >= min_size)
        boxes_all.append(boxes)
        scores_all.append(torch.where(valid, top_scores, NEG_INF))

    width_k = max(s.shape[1] for s in scores_all)
    padded_boxes = torch.stack([F.pad(b, (0, 0, 0, width_k - b.shape[1]))
                                for b in boxes_all], dim=1)          # (B, L, K, 4)
    padded_scores = torch.stack([F.pad(s, (0, width_k - s.shape[1]), value=NEG_INF)
                                 for s in scores_all], dim=1)        # (B, L, K)
    keep = nms_mask(padded_boxes, padded_scores, nms_thresh)
    kept = torch.where(keep, padded_scores, NEG_INF)
    scores_cat = torch.cat([kept[:, lvl, :s.shape[1]] for lvl, s in enumerate(scores_all)],
                           dim=1)
    boxes_cat = torch.cat(boxes_all, dim=1)
    return top_k_by_score(boxes_cat, scores_cat, post_nms_top_n)
