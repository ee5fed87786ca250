"""Faster R-CNN training, the counterpart of
`objectpermanence_tpu/models/detector/training.py`: IoU matching, balanced
sampling, the RPN and RoI losses, and the train step.

The torchvision recipe the reference fine-tunes with:
- RPN: matcher 0.7/0.3 with low-quality matches allowed; 256 sampled
  anchors per image at 0.5 positive fraction; BCE objectness + smooth-L1
  (beta 1/9) box loss on the positives.
- RoI heads: matcher 0.5/0.5; 512 sampled proposals per image at 0.25
  positive fraction, the ground-truth boxes appended to the proposals; CE
  class loss + smooth-L1 (beta 1) box loss on the positives.

Ground truth is padded to a fixed count with a validity mask. Where JAX
`vmap`s the losses over the images, the port runs them as a batch
dimension: each image keeps its own sample count, and each loss part is the
mean over the images.

Sampling ranks candidates by uniform draws, as JAX's does; the port cannot
reproduce `jax.random`, so the draws are arguments (`Draws`): the train step
makes them with a `torch.Generator` on the device, and a test can pass
JAX's own. Ties go to the lower index, as `lax.top_k` and the stable
`jnp.argsort` break them.
"""

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from objectpermanence_tpu_torch.models.detector.boxcoder import ROI_WEIGHTS, RPN_WEIGHTS, encode
from objectpermanence_tpu_torch.models.detector.detector import (
    DetectorConfig, batched_roi_align, check_supported, forward_features, preprocess_images,
)
from objectpermanence_tpu_torch.models.detector.rpn import generate_proposals
from objectpermanence_tpu_torch.ops.boxes import pairwise_iou_xyxy
from objectpermanence_tpu_torch.ops.nms import NEG_INF

BELOW_LOW = -1
BETWEEN = -2
RPN_SAMPLES, RPN_POSITIVE_FRACTION = 256, 0.5
ROI_SAMPLES, ROI_POSITIVE_FRACTION = 512, 0.25
LOSS_NAMES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")


class Draws(NamedTuple):
    """Uniform [0, 1) draws that rank the sampled candidates, (B, N) each:
    positives and negatives of the RPN's anchors and of the RoI heads'
    proposals (+ ground truth)."""
    rpn_pos: torch.Tensor
    rpn_neg: torch.Tensor
    roi_pos: torch.Tensor
    roi_neg: torch.Tensor

    @classmethod
    def sample(cls, batch: int, num_anchors: int, num_rois: int, device,
               generator: Optional[torch.Generator] = None) -> "Draws":
        def rand(n):
            return torch.rand((batch, n), generator=generator, device=device)
        return cls(rand(num_anchors), rand(num_anchors), rand(num_rois), rand(num_rois))


def match_boxes(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, candidates: torch.Tensor,
                high: float, low: float, allow_low_quality: bool) -> torch.Tensor:
    """gt_boxes (B, G, 4), gt_valid (B, G), candidates (B, N, 4) or (N, 4)
    -> the matched ground truth's index per candidate (B, N), or BELOW_LOW /
    BETWEEN. argmax takes the first maximum, as `jnp.argmax` does."""
    iou = pairwise_iou_xyxy(gt_boxes, candidates)                    # (B, G, N)
    iou = torch.where(gt_valid[..., None], iou, torch.full((), -1.0, device=iou.device))
    best_iou = iou.amax(dim=1)
    best_gt = iou.argmax(dim=1)
    matches = torch.where(best_iou >= high, best_gt, BETWEEN)
    matches = torch.where(best_iou < low, BELOW_LOW, matches)
    if allow_low_quality:
        # every gt's best candidate(s) become positive regardless of IoU
        best_per_gt = iou.amax(dim=2, keepdim=True)                  # (B, G, 1)
        force = ((iou == best_per_gt) & gt_valid[..., None]).any(dim=1)
        matches = torch.where(force, best_gt, matches)
    return matches


def balanced_sample(matches: torch.Tensor, num_samples: int, positive_fraction: float,
                    pos_draws: torch.Tensor, neg_draws: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random balanced subset of each row of `matches (B, N)`: at most
    `num_samples * positive_fraction` positives (matches >= 0), negatives
    (BELOW_LOW) to fill `num_samples`, each ranked by its draw, highest
    first. -> (sampled (B, N), positive (B, N)) masks."""
    positive = matches >= 0
    negative = matches == BELOW_LOW
    n = matches.shape[-1]
    num_pos_wanted = int(num_samples * positive_fraction)

    pos_priority = torch.where(positive, pos_draws, -1.0)
    # lax.top_k: the k largest, ties lower index first
    pos_idx = torch.argsort(-pos_priority, dim=-1, stable=True)[..., :min(num_pos_wanted, n)]
    pos_mask = torch.zeros_like(positive).scatter_(-1, pos_idx, True) & positive
    num_pos = pos_mask.sum(dim=-1, keepdim=True)

    num_neg_wanted = num_samples - torch.clamp(num_pos, max=num_pos_wanted)
    neg_priority = torch.where(negative, neg_draws, -1.0)
    neg_sorted = torch.argsort(-neg_priority, dim=-1, stable=True)
    ranks = torch.arange(n, device=matches.device).expand_as(neg_sorted)
    neg_rank = torch.empty_like(neg_sorted).scatter_(-1, neg_sorted, ranks)
    neg_mask = negative & (neg_rank < num_neg_wanted)
    return pos_mask | neg_mask, pos_mask


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * x * x / beta, ax - 0.5 * beta)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, G, D) at idx (B, N) -> (B, N, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _sampled_mean(loss: torch.Tensor, mask: torch.Tensor, num_sampled: torch.Tensor):
    """Per image: the masked sum of `loss (B, N[, D])` over the sample count."""
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    summed = torch.where(mask, loss, zero).reshape(loss.shape[0], -1).sum(dim=1)
    return summed / num_sampled


def rpn_loss(objectness: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
             gt_boxes: torch.Tensor, gt_valid: torch.Tensor, pos_draws: torch.Tensor,
             neg_draws: torch.Tensor, batch_per_image: int = RPN_SAMPLES,
             positive_fraction: float = RPN_POSITIVE_FRACTION
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """objectness (B, N) logits, deltas (B, N, 4), anchors (N, 4) ->
    (cls_loss (B,), reg_loss (B,)), each image's own."""
    matches = match_boxes(gt_boxes, gt_valid, anchors, 0.7, 0.3, allow_low_quality=True)
    sampled, pos = balanced_sample(matches, batch_per_image, positive_fraction,
                                   pos_draws, neg_draws)
    num_sampled = sampled.sum(dim=-1).clamp(min=1)

    labels = (matches >= 0).to(objectness.dtype)
    # optax.sigmoid_binary_cross_entropy
    bce = -labels * F.logsigmoid(objectness) - (1.0 - labels) * F.logsigmoid(-objectness)
    cls_loss = _sampled_mean(bce, sampled, num_sampled)

    matched_gt = _gather_rows(gt_boxes, matches.clamp(min=0))
    target = encode(matched_gt, anchors, RPN_WEIGHTS)
    reg = smooth_l1(deltas - target, beta=1.0 / 9)
    reg_loss = _sampled_mean(reg, pos[..., None], num_sampled)
    return cls_loss, reg_loss


def roi_loss(cls_logits: torch.Tensor, box_deltas: torch.Tensor, props: torch.Tensor,
             prop_scores: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
             gt_valid: torch.Tensor, pos_draws: torch.Tensor, neg_draws: torch.Tensor,
             batch_per_image: int = ROI_SAMPLES,
             positive_fraction: float = ROI_POSITIVE_FRACTION
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The box head's outputs for every proposal (+ appended ground truth):
    cls_logits (B, M, K), box_deltas (B, M, K, 4); props (B, M, 4) and
    their scores (B, M), NEG_INF for padding -> (cls_loss (B,), reg_loss
    (B,))."""
    valid_prop = prop_scores > NEG_INF / 10
    matches = match_boxes(gt_boxes, gt_valid, props, 0.5, 0.5, allow_low_quality=False)
    matches = torch.where(valid_prop, matches, BELOW_LOW)
    sampled, pos = balanced_sample(matches, batch_per_image, positive_fraction,
                                   pos_draws, neg_draws)
    sampled = sampled & valid_prop
    num_sampled = sampled.sum(dim=-1).clamp(min=1)

    matched_idx = matches.clamp(min=0)
    matched_labels = torch.gather(gt_labels.to(torch.int64), 1, matched_idx)
    target_labels = torch.where(pos, matched_labels, 0)               # 0 = background
    # optax.softmax_cross_entropy_with_integer_labels
    ce = -torch.gather(F.log_softmax(cls_logits, dim=-1), -1, target_labels[..., None])[..., 0]
    cls_loss = _sampled_mean(ce, sampled, num_sampled)

    target = encode(_gather_rows(gt_boxes, matched_idx), props, ROI_WEIGHTS)
    # the deltas of each sample's target class
    per_class = torch.gather(
        box_deltas, 2, target_labels[..., None, None].expand(*target_labels.shape, 1, 4))[:, :, 0]
    reg = smooth_l1(per_class - target, beta=1.0)
    reg_loss = _sampled_mean(reg, pos[..., None], num_sampled)
    return cls_loss, reg_loss


def detection_loss(model, images: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_valid: torch.Tensor, config: DetectorConfig, anchors: List[torch.Tensor],
                   draws: Optional[Draws] = None,
                   generator: Optional[torch.Generator] = None,
                   on_stage: Optional[Callable[[str], None]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total Faster R-CNN loss of a batch, the sum of its four parts
    (the reference's loss dict), each the mean over the images. Raw frames
    (B, H, W, 3); ground truth (B, G, 4) in the frames' coordinates, labels
    and validity (B, G). Without `draws`, they are made from `generator`.
    `on_stage(name)`, if given, is called as each stage has been issued:
    "backbone_fpn", "rpn_proposals", "roi_align", "heads_losses"."""
    check_supported(config, training=True)
    mark = on_stage or (lambda name: None)
    pyramid = forward_features(model, preprocess_images(images, config))
    mark("backbone_fpn")
    objectness, deltas = model.rpn.head(pyramid)
    obj_cat = torch.cat(objectness, dim=1)                           # (B, N)
    deltas_cat = torch.cat(deltas, dim=1)                            # (B, N, 4)
    anchors_cat = torch.cat(anchors)                                 # (N, 4)

    with torch.no_grad():  # proposals are constants, as JAX's stop_gradient makes them
        proposals, prop_scores = generate_proposals(
            [torch.sigmoid(o) for o in objectness], deltas, anchors, config.padded_hw,
            config.rpn_pre_nms_top_n, config.rpn_post_nms_top_n, config.rpn_nms_thresh)
        # ground truth in the padded pyramid's coordinates, appended to the
        # proposals (torchvision's add_gt_proposals)
        gt_scaled = gt_boxes * config.scale
        all_props = torch.cat([proposals, gt_scaled], dim=1)            # (B, P+G, 4)
        all_scores = torch.cat([prop_scores, torch.where(
            gt_valid, torch.ones((), device=gt_valid.device), NEG_INF)], dim=1)

    batch = images.shape[0]
    if draws is None:
        draws = Draws.sample(batch, anchors_cat.shape[0], all_props.shape[1], images.device,
                             generator)
    mark("rpn_proposals")
    pooled = batched_roi_align(pyramid[:4], all_props, config)       # (B, P+G, C, 7, 7)
    mark("roi_align")
    cls_logits, box_deltas = model.roi_heads(pooled)

    rpn_cls, rpn_reg = rpn_loss(obj_cat, deltas_cat, anchors_cat, gt_scaled, gt_valid,
                                draws.rpn_pos, draws.rpn_neg)
    roi_cls, roi_reg = roi_loss(cls_logits, box_deltas, all_props, all_scores, gt_scaled,
                                gt_labels, gt_valid, draws.roi_pos, draws.roi_neg)
    parts = {name: v.mean() for name, v in zip(LOSS_NAMES, (rpn_cls, rpn_reg, roi_cls, roi_reg))}
    total = sum(parts.values())
    mark("heads_losses")
    return total, parts


def trainable_tensors(model) -> List[Tuple[str, torch.Tensor]]:
    """What the JAX package's optimizer updates: every parameter and, since
    JAX keeps frozen batch-norm's scale, bias, mean and variance as leaves
    of its parameter tree (nothing stops their gradient), those buffers too.
    Marks the buffers as requiring a gradient; returns (name, tensor) pairs
    in `state_dict` order."""
    params = dict(model.named_parameters())
    out = []
    for name, tensor in model.state_dict(keep_vars=True).items():
        if name not in params:
            tensor.requires_grad_(True)
        out.append((name, tensor))
    return out


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """`optax.clip_by_global_norm` in place: each gradient becomes
    `g / norm * max_norm` when the global norm (`optax.global_norm`) is at
    least `max_norm`, and stays as it is below (divided and multiplied by
    1). A few multi-tensor launches, no wait on the host. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, torch.full_like(one, max_norm), one))
    return norm


def make_detector_train_step(config: DetectorConfig, anchors: List[torch.Tensor],
                             optimizer: torch.optim.Optimizer, schedule, max_norm: float = 10.0):
    """-> step(model, images, gt_boxes, gt_labels, gt_valid, draws=None,
    generator=None, on_stage=None) -> the loss parts and their sum
    ("loss"), on the device. `on_stage` is `detection_loss`'s, called also
    after "backward" and "optimizer".

    One update of JAX's chain `clip_by_global_norm(max_norm)` ->
    `add_decayed_weights` -> `sgd(schedule, momentum)`: the optimizer is a
    `torch.optim.SGD` with the same momentum and weight decay (dampening 0)
    over `trainable_tensors`; before each update its learning rate is set
    to `schedule(count)`, `count` the updates so far (`step.count`, from
    0)."""
    tensors = [t for group in optimizer.param_groups for t in group["params"]]

    def step(model, images, gt_boxes, gt_labels, gt_valid, draws: Optional[Draws] = None,
             generator: Optional[torch.Generator] = None,
             on_stage: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        mark = on_stage or (lambda name: None)
        optimizer.zero_grad(set_to_none=False)
        loss, parts = detection_loss(model, images, gt_boxes, gt_labels, gt_valid, config,
                                     anchors, draws, generator, on_stage)
        loss.backward()
        mark("backward")
        with torch.no_grad():
            clip_by_global_norm_([t.grad for t in tensors], max_norm)
        for group in optimizer.param_groups:
            group["lr"] = schedule(step.count)
        optimizer.step()
        step.count += 1
        mark("optimizer")
        return {**{k: v.detach() for k, v in parts.items()}, "loss": loss.detach()}

    step.count = 0
    return step
