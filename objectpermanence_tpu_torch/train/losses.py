"""Losses, the counterpart of `objectpermanence_tpu/train/losses.py`: L1
prediction, temporal consistency, attention cross-entropy.

- `pred_loss` is the elementwise L1 over (B, T, 4); for `*_no_labels`
  models the mask multiplies it BEFORE the mean, so the mean still runs over
  all elements.
- `consistency_loss` is the mean over (B, T-1) of the L2 norm of adjacent
  output deltas, with `eps` inside the sqrt so the gradient at a zero delta
  is finite.
- total = pred + 0.5 * consistency for no-labels models, else pred only.
- `sample_weight` (B,) zeroes the repeated rows that pad a ragged last batch.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

CONSISTENCY_RATE = 0.5


def _weighted_mean(loss: torch.Tensor, sample_weight: torch.Tensor) -> torch.Tensor:
    """Mean with per-sample (leading-axis) weights, normalized so that
    all-ones weights give the plain mean."""
    w = sample_weight.reshape((-1,) + (1,) * (loss.dim() - 1))
    denom = torch.clamp(sample_weight.mean(), min=1e-12)
    return (loss * w).mean() / denom


def l1_pred_loss(output: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor = None,
                 sample_weight: torch.Tensor = None) -> torch.Tensor:
    loss = (output - labels).abs()
    if mask is not None:
        loss = loss * mask
    if sample_weight is not None:
        return _weighted_mean(loss, sample_weight)
    return loss.mean()


def consistency_loss(output: torch.Tensor, eps: float = 1e-12,
                     sample_weight: torch.Tensor = None) -> torch.Tensor:
    deltas = output[:, 1:, :] - output[:, :-1, :]
    norms = torch.sqrt((deltas * deltas).sum(dim=-1) + eps)
    if sample_weight is not None:
        return _weighted_mean(norms, sample_weight)
    return norms.mean()


def attention_ce_loss(logits: torch.Tensor, index_to_track: torch.Tensor,
                      sample_weight: torch.Tensor = None) -> torch.Tensor:
    """Cross-entropy of the who-to-attend logits `(B, objects, T)` against
    the containment oracle's slot per frame `(B, T)`."""
    ce = F.cross_entropy(logits, index_to_track.long(), reduction="none")  # (B, T)
    if sample_weight is not None:
        return _weighted_mean(ce, sample_weight)
    return ce.mean()


def total_loss(output: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, no_labels: bool,
               sample_weight: torch.Tensor = None) -> Tuple[torch.Tensor, dict]:
    cons = consistency_loss(output, sample_weight=sample_weight)
    if no_labels:
        pred = l1_pred_loss(output, labels, mask.to(output.dtype), sample_weight=sample_weight)
        loss = pred + CONSISTENCY_RATE * cons
    else:
        pred = l1_pred_loss(output, labels, sample_weight=sample_weight)
        loss = pred
    return loss, {"loss": loss, "pred_loss": pred, "consistency_loss": cons}
