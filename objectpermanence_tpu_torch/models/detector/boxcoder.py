"""Box delta encode/decode, the counterpart of
`objectpermanence_tpu/models/detector/boxcoder.py` (Faster R-CNN
parameterization with per-stage weights and the log(1000/16) clamp)."""

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)

RPN_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
ROI_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def encode(reference: torch.Tensor, proposals: torch.Tensor, weights,
           eps: float = 1e-3) -> torch.Tensor:
    """Deltas such that decode(proposals, deltas) == reference; sizes are
    eps-clamped so padded (zero) boxes give finite deltas."""
    wx, wy, ww, wh = weights
    px = (proposals[..., 0] + proposals[..., 2]) / 2
    py = (proposals[..., 1] + proposals[..., 3]) / 2
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=eps)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=eps)

    gx = (reference[..., 0] + reference[..., 2]) / 2
    gy = (reference[..., 1] + reference[..., 3]) / 2
    gw = (reference[..., 2] - reference[..., 0]).clamp(min=eps)
    gh = (reference[..., 3] - reference[..., 1]).clamp(min=eps)

    dx = wx * (gx - px) / pw
    dy = wy * (gy - py) / ph
    dw = ww * torch.log(gw / pw)
    dh = wh * torch.log(gh / ph)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode(proposals: torch.Tensor, deltas: torch.Tensor, weights) -> torch.Tensor:
    wx, wy, ww, wh = weights
    px = (proposals[..., 0] + proposals[..., 2]) / 2
    py = (proposals[..., 1] + proposals[..., 3]) / 2
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)

    cx = dx * pw + px
    cy = dy * ph + py
    w = torch.exp(dw) * pw
    h = torch.exp(dh) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def clip_to_image(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return torch.stack([
        boxes[..., 0].clamp(0, width),
        boxes[..., 1].clamp(0, height),
        boxes[..., 2].clamp(0, width),
        boxes[..., 3].clamp(0, height),
    ], dim=-1)
