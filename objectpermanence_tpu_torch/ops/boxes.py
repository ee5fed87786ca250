"""Box geometry, the counterpart of `objectpermanence_tpu/ops/boxes.py`.

Boxes are `[x1, y1, x2, y2]` in pixels or normalized by `FRAME_SHAPES`;
`iou_xyxy` keeps the reference pipeline's +1 pixel-area convention,
`pairwise_iou_xyxy` the detector's zero-area one.
"""

import numpy as np
import torch

# width, height, width, height: the CATER frame shape used for normalization
FRAME_SHAPES = np.array([320.0, 240.0, 320.0, 240.0])


def denormalize_boxes(boxes: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Normalized boxes -> integer pixels: the product in the boxes' dtype
    (float32, as the JAX package computes it on the device), truncated
    toward zero."""
    scale = torch.as_tensor(FRAME_SHAPES, dtype=boxes.dtype, device=boxes.device)
    return (boxes * scale).to(dtype)


def iou_xyxy(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of two (..., 4) xyxy box tensors with the +1 area
    convention. Returns (...,) float; integer pixel boxes give float64, as
    numpy's true division does."""
    if not boxes_a.is_floating_point():
        boxes_a = boxes_a.double()
    if not boxes_b.is_floating_point():
        boxes_b = boxes_b.double()
    xa = torch.maximum(boxes_a[..., 0], boxes_b[..., 0])
    ya = torch.maximum(boxes_a[..., 1], boxes_b[..., 1])
    xb = torch.minimum(boxes_a[..., 2], boxes_b[..., 2])
    yb = torch.minimum(boxes_a[..., 3], boxes_b[..., 3])
    inter = (xb - xa + 1).clamp(min=0) * (yb - ya + 1).clamp(min=0)
    area_a = (boxes_a[..., 2] - boxes_a[..., 0] + 1) * (boxes_a[..., 3] - boxes_a[..., 1] + 1)
    area_b = (boxes_b[..., 2] - boxes_b[..., 0] + 1) * (boxes_b[..., 3] - boxes_b[..., 1] + 1)
    return inter / (area_a + area_b - inter)


def pairwise_iou_xyxy(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU: (..., N, 4) x (..., M, 4) -> (..., N, M), batched over
    any leading dimensions. Zero-area convention (no +1), as detection NMS
    and matching use it."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    xa = torch.maximum(a[..., 0], b[..., 0])
    ya = torch.maximum(a[..., 1], b[..., 1])
    xb = torch.minimum(a[..., 2], b[..., 2])
    yb = torch.minimum(a[..., 3], b[..., 3])
    inter = (xb - xa).clamp(min=0) * (yb - ya).clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros((), dtype=inter.dtype,
                                                            device=inter.device))
