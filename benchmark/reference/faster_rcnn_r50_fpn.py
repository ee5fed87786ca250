"""Faster R-CNN R50-FPN inference, plain PyTorch: torchvision's
`fasterrcnn_resnet50_fpn` with its box predictor replaced for 193 classes
(ofrikleinfeld/ObjectPermanence `object_detection/models.py`), run at this
repository's `configs/preprocess_config.json`.

- Frames: uint8 RGB divided by 256 (the reference repo's scaling), then
  torchvision's ImageNet mean and std; 240 x 320 is inside min 240 / max
  320, so no resize; zero padding to multiples of 32 (256 x 320).
- Backbone: ResNet-50 v1.5 (the stride on each stage's first 3x3) with
  frozen batch norm (eps 1e-5); FPN of 256 over C2-C5, nearest top-down,
  P6 a stride-2 subsample of P5.
- RPN: a 3x3 conv and two 1x1s over P2-P6; anchors of 32-512, one size a
  level, ratios 0.5 / 1 / 2, base anchors rounded; per level the top 500
  by objectness, decoded (weights 1, 1, 1, 1, dw and dh clamped at
  log(1000/16)), clipped, boxes under 1e-3 dropped, NMS at 0.7; then the
  top 300 over all levels.
- Heads: RoIAlign 7 x 7, sampling ratio 2, aligned false, each roi on
  level floor(4 + log2(sqrt(area) / 224 + 1e-6)) clamped to P2-P5; fc6 and
  fc7 of 1024 with ReLU; 193 scores and 193 x 4 deltas (weights 10, 10, 5,
  5); softmax; the background column dropped; scores under 0.05 and boxes
  under 1e-2 dropped; NMS at 0.5 within a class; the top 100.

RoIAlign is bilinear sampling by gather, torchvision's CPU kernel in
tensors. NMS is the greedy loop: boxes in score order, each kept unless a
kept box of its row (and, in the heads, of its class) overlaps it by IoU
above the threshold; one loop serves every row of a batch.

Where this follows the port instead of torchvision (each changes no
detection at the cell's traffic but the first, which the port shares with
the JAX package it is held to; `configs/faster_rcnn_r50_fpn.json`,
`departures`):
- boxes are clipped to the padded 256 x 320 frame, where torchvision clips
  to the 240 x 320 image (`detector.py::detect_forward` passes
  `padded_hw`);
- a level's candidates are ranked by the sigmoid of their objectness with
  ties to the lower index, and the 300 are taken over the levels'
  candidates in level order, ties likewise (torchvision's `topk` of logits
  names no tie order);
- at most the 1000 best candidates of an image enter the class NMS
  (`roi_heads.py::postprocess_detections`), and a score of exactly 0.05
  counts (torchvision: above 0.05);
- outputs are fixed-width: 100 detections an image, the rest marked
  invalid (the port pads them with `NEG_INF` scores).

`precision` "fp32" computes every product in float32 (TF32 off, as
`benchmark/run.py` sets it); "tf32", the control, rounds both operands of
every convolution and linear layer to TF32 first (`common.tf32`).
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference.common import PRECISIONS, tf32

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
NORM_EPS = 1e-5
RATIOS = (0.5, 1.0, 2.0)
XFORM_CLIP = math.log(1000.0 / 16)
RPN_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
ROI_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
CANDIDATES = 1000


def _operands(precision, *tensors):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return [tf32(t) if precision == "tf32" else t for t in tensors]


def _conv(w, name, x, precision, stride=1, bias=True):
    weight = w[f"{name}.weight"]
    x, weight = _operands(precision, x, weight)
    return F.conv2d(x, weight, w[f"{name}.bias"] if bias else None, stride,
                    weight.shape[-1] // 2)


def _linear(w, name, x, precision):
    x, weight = _operands(precision, x, w[f"{name}.weight"])
    return F.linear(x, weight, w[f"{name}.bias"])


def _norm(w, name, x):
    """torchvision's FrozenBatchNorm2d."""
    scale = w[f"{name}.weight"] * (w[f"{name}.running_var"] + NORM_EPS).rsqrt()
    shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _bottleneck(w, p, x, stride, precision):
    out = F.relu(_norm(w, f"{p}.bn1", _conv(w, f"{p}.conv1", x, precision, bias=False)))
    out = F.relu(_norm(w, f"{p}.bn2", _conv(w, f"{p}.conv2", out, precision, stride, False)))
    out = _norm(w, f"{p}.bn3", _conv(w, f"{p}.conv3", out, precision, bias=False))
    if f"{p}.downsample.0.weight" in w:
        x = _norm(w, f"{p}.downsample.1",
                  _conv(w, f"{p}.downsample.0", x, precision, stride, False))
    return F.relu(out + x)


def pyramid(w, images, config, precision="fp32"):
    """uint8 frames (B, H, W, 3) -> [P2, P3, P4, P5, P6], each (B, 256, h, w)."""
    x = images.to(torch.float32) / 256.0
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    ph, pw = _padded(config)
    x = F.pad(x, (0, pw - x.shape[3], 0, ph - x.shape[2]))
    body = "backbone.body"
    x = F.relu(_norm(w, f"{body}.bn1", _conv(w, f"{body}.conv1", x, precision, 2, False)))
    x = F.max_pool2d(x, 3, 2, 1)
    features = []
    for stage, blocks in enumerate(config["backbone_layers"]):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            x = _bottleneck(w, f"{body}.layer{stage + 1}.{b}", x, stride, precision)
        features.append(x)
    last = _conv(w, f"backbone.fpn.inner_blocks.{len(features) - 1}", features[-1], precision)
    outs = [_conv(w, f"backbone.fpn.layer_blocks.{len(features) - 1}", last, precision)]
    for i in range(len(features) - 2, -1, -1):
        lateral = _conv(w, f"backbone.fpn.inner_blocks.{i}", features[i], precision)
        last = lateral + F.interpolate(last, size=lateral.shape[-2:], mode="nearest")
        outs.insert(0, _conv(w, f"backbone.fpn.layer_blocks.{i}", last, precision))
    return outs + [F.max_pool2d(outs[-1], 1, 2, 0)]


def _padded(config):
    h, w = config["image_hw"]
    p = config["preprocess_config"]
    scale = min(p["min_size"] / min(h, w), p["max_size"] / max(h, w))
    if scale != 1.0:
        raise ValueError("the reference runs frames at their own size (scale 1)")
    return math.ceil(h / 32) * 32, math.ceil(w / 32) * 32


def anchors(feature_hw, stride, size, device):
    """torchvision's AnchorGenerator for one level, in float32: (h*w*3, 4),
    position-major."""
    ratios = torch.tensor(RATIOS, device=device)
    h_ratios = torch.sqrt(ratios)
    w_ratios = 1 / h_ratios
    ws, hs = w_ratios * size, h_ratios * size
    base = (torch.stack([-ws, -hs, ws, hs], dim=1) / 2).round()
    ys = torch.arange(feature_hw[0], dtype=torch.float32, device=device) * stride
    xs = torch.arange(feature_hw[1], dtype=torch.float32, device=device) * stride
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode(boxes, deltas, weights):
    """torchvision's BoxCoder.decode_single, broadcast over leading dims."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=XFORM_CLIP)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=-1)


def _clip(boxes, height, width):
    x = boxes[..., 0::2].clamp(0, width)
    y = boxes[..., 1::2].clamp(0, height)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def _wide_enough(boxes, min_size):
    return ((boxes[..., 2] - boxes[..., 0]) >= min_size) & \
        ((boxes[..., 3] - boxes[..., 1]) >= min_size)


def box_iou(a, b):
    """torchvision's box_iou, batched: (..., n, 4) x (..., m, 4) -> (..., n, m)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def _sort_desc(scores):
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def _take(x, idx):
    rest = x.shape[idx.dim():]
    index = idx.reshape(*idx.shape, *([1] * len(rest))).expand(*idx.shape, *rest)
    return torch.gather(x, idx.dim() - 1, index)


def greedy_nms(boxes, scores, valid, threshold, labels=None):
    """Greedy NMS over each row of a batch: boxes (R, n, 4), scores and
    valid (R, n), labels (R, n) or None -> the kept mask (R, n) in the input
    order. In score order (ties to the lower index), a valid box is kept
    unless a box kept before it in its row (of its label, where labels are
    given) overlaps it with IoU above `threshold`."""
    order = _sort_desc(torch.where(valid, scores, torch.full_like(scores, -math.inf)))
    boxes, valid = _take(boxes, order), torch.gather(valid, 1, order)
    over = box_iou(boxes, boxes) > threshold
    if labels is not None:
        labels = torch.gather(labels, 1, order)
        over &= labels[:, :, None] == labels[:, None, :]
    removed = ~valid
    keep = torch.zeros_like(valid)
    for i in range(boxes.shape[1]):
        kept = ~removed[:, i]
        keep[:, i] = kept
        removed |= kept[:, None] & over[:, i]
    return torch.zeros_like(keep).scatter_(1, order, keep)


def proposals(w, levels, config, precision="fp32"):
    """P2-P6 -> (proposals (B, 300, 4), valid (B, 300), stats)."""
    p = config["preprocess_config"]
    height, width = _padded(config)
    batch, device = levels[0].shape[0], levels[0].device
    boxes_l, scores_l, valid_l = [], [], []
    for i, feat in enumerate(levels):
        t = F.relu(_conv(w, "rpn.head.conv", feat, precision))
        logits = _conv(w, "rpn.head.cls_logits", t, precision).permute(0, 2, 3, 1)
        logits = logits.reshape(batch, -1)
        deltas = _conv(w, "rpn.head.bbox_pred", t, precision)
        deltas = deltas.view(batch, -1, 4, *deltas.shape[-2:]).permute(0, 3, 4, 1, 2)
        deltas = deltas.reshape(batch, -1, 4)
        stride = 4 * 2 ** i
        base = anchors(feat.shape[-2:], stride, config["anchor_sizes"][i], device)
        scores = torch.sigmoid(logits)
        top = _sort_desc(scores)[:, :min(p["rpn_pre_nms_top_n"], scores.shape[1])]
        boxes = _clip(decode(base[top], _take(deltas, top), RPN_WEIGHTS), height, width)
        boxes_l.append(boxes)
        scores_l.append(torch.gather(scores, 1, top))
        valid_l.append(_wide_enough(boxes, 1e-3))
    kept_l, suppressed, considered = [], 0, 0
    for boxes, scores, valid in zip(boxes_l, scores_l, valid_l):
        kept = greedy_nms(boxes, scores, valid, config["rpn_nms_thresh"])
        suppressed += int((valid & ~kept).sum())
        considered += int(valid.sum())
        kept_l.append(kept)
    scores = torch.cat([torch.where(k, s, torch.full_like(s, -math.inf))
                        for k, s in zip(kept_l, scores_l)], dim=1)
    top = _sort_desc(scores)[:, :p["rpn_post_nms_top_n"]]
    chosen = torch.gather(scores, 1, top)
    return (_take(torch.cat(boxes_l, dim=1), top), chosen > -math.inf,
            {"rpn_suppressed": suppressed / max(considered, 1)})


def _roi_levels(rois):
    area = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    k = torch.floor(4 + torch.log2(torch.sqrt(area) / 224 + 1e-6))
    return (k.clamp(2, 5) - 2).to(torch.int64)


def roi_align(levels, rois, pooled=7, sampling=2):
    """torchvision's multi-scale RoIAlign (aligned false) for one image:
    levels [(C, h, w)] of P2-P5, rois (N, 4) in image pixels -> (N, C, 7, 7)."""
    c = levels[0].shape[0]
    level = _roi_levels(rois)
    shapes = torch.tensor([f.shape[-2:] for f in levels], device=rois.device)
    offsets = torch.cumsum(torch.cat([shapes.new_zeros(1), shapes.prod(1)[:-1]]), 0)
    table = torch.cat([f.permute(1, 2, 0).reshape(-1, c) for f in levels])
    scale = (0.25 / 2 ** level.to(torch.float32))[:, None]
    start = rois[:, :2] * scale                                           # (N, 2) x, y
    size = (rois[:, 2:] * scale - start).clamp(min=1.0)
    bins = size / pooled
    grid = torch.arange(pooled, device=rois.device, dtype=torch.float32)
    sub = (torch.arange(sampling, device=rois.device, dtype=torch.float32) + 0.5)
    # sample k of an axis: start + ph * bin + (iy + .5) * bin / sampling
    ph = grid.repeat_interleave(sampling)
    iy = sub.repeat(pooled)
    xs = start[:, 0:1] + ph * bins[:, 0:1] + iy * bins[:, 0:1] / sampling   # (N, k)
    ys = start[:, 1:2] + ph * bins[:, 1:2] + iy * bins[:, 1:2] / sampling
    h = shapes[level, 0][:, None, None].to(torch.float32)
    w = shapes[level, 1][:, None, None].to(torch.float32)
    y = ys[:, :, None].expand(-1, -1, xs.shape[1])
    x = xs[:, None, :].expand(-1, ys.shape[1], -1)
    outside = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    y, x = y.clamp(min=0), x.clamp(min=0)
    y_low, x_low = y.floor(), x.floor()
    y_edge, x_edge = y_low >= h - 1, x_low >= w - 1
    y_low = torch.where(y_edge, h - 1, y_low)
    x_low = torch.where(x_edge, w - 1, x_low)
    y = torch.where(y_edge, y_low, y)
    x = torch.where(x_edge, x_low, x)
    y_high = torch.where(y_edge, y_low, y_low + 1)
    x_high = torch.where(x_edge, x_low, x_low + 1)
    ly, lx = y - y_low, x - x_low
    hy, hx = 1 - ly, 1 - lx
    row0 = offsets[level][:, None, None]
    width = shapes[level, 1][:, None, None]

    def tap(yy, xx):
        return table[row0 + yy.to(torch.int64) * width + xx.to(torch.int64)]

    val = ((hy * hx)[..., None] * tap(y_low, x_low) + (hy * lx)[..., None] * tap(y_low, x_high)
           + (ly * hx)[..., None] * tap(y_high, x_low) + (ly * lx)[..., None] * tap(y_high, x_high))
    val = torch.where(outside[..., None], torch.zeros((), device=val.device), val)
    n = rois.shape[0]
    val = val.reshape(n, pooled, sampling, pooled, sampling, c).sum(dim=(2, 4)) / (sampling ** 2)
    return val.permute(0, 3, 1, 2)


def box_logits(w, levels, rois, config, precision="fp32"):
    """P2-P5 and proposals (B, 300, 4) -> the box head's class logits
    (B, 300, 193) and box deltas (B, 300, 193 x 4)."""
    pooled = torch.stack([roi_align([f[b] for f in levels[:4]], rois[b],
                                    config["roi_output_size"], config["sampling_ratio"])
                          for b in range(rois.shape[0])])
    x = pooled.reshape(*rois.shape[:2], -1)
    x = F.relu(_linear(w, "roi_heads.box_head.fc6", x, precision))
    x = F.relu(_linear(w, "roi_heads.box_head.fc7", x, precision))
    return (_linear(w, "roi_heads.box_predictor.cls_score", x, precision),
            _linear(w, "roi_heads.box_predictor.bbox_pred", x, precision))


def detections(logits, deltas, rois, roi_valid, config):
    """The box head's outputs for proposals (B, N, 4) and their valid mask
    -> dict of `boxes (B, D, 4)`, `labels`, `scores`, `valid` (B, D) and
    `stats`."""
    height, width = _padded(config)
    batch, n, classes = logits.shape
    boxes = _clip(decode(rois[:, :, None, :], deltas.reshape(batch, n, classes, 4),
                         ROI_WEIGHTS), height, width)[:, :, 1:].reshape(batch, -1, 4)
    scores = torch.softmax(logits, dim=-1)[:, :, 1:].reshape(batch, -1)
    labels = torch.arange(1, classes, device=rois.device).repeat(n).expand(batch, -1)
    valid = roi_valid[:, :, None].expand(-1, -1, classes - 1).reshape(batch, -1)
    valid = valid & (scores >= config["score_thresh"]) & _wide_enough(boxes, 1e-2)
    count = valid.sum(1)
    top = _sort_desc(torch.where(valid, scores, torch.full_like(scores, -math.inf)))
    # past the most valid candidates of an image nothing is kept
    top = top[:, :min(CANDIDATES, max(int(count.max()), config["detections_per_img"]))]
    boxes, scores, labels, valid = (_take(boxes, top), torch.gather(scores, 1, top),
                                    torch.gather(labels, 1, top), torch.gather(valid, 1, top))
    kept = greedy_nms(boxes, scores, valid, config["nms_thresh"], labels)
    final = _sort_desc(torch.where(kept, scores, torch.full_like(scores, -math.inf)))
    final = final[:, :config["detections_per_img"]]
    stats = {"candidates_max": int(count.max()),
             "class_suppressed": int((valid & ~kept).sum()) / max(int(valid.sum()), 1)}
    return {"boxes": _take(boxes, final), "labels": torch.gather(labels, 1, final),
            "scores": torch.gather(scores, 1, final), "valid": torch.gather(kept, 1, final),
            "stats": stats}


@torch.no_grad()
def forward(w, images, config, precision="fp32"):
    """uint8 frames (B, 240, 320, 3) -> dict of `boxes (B, 100, 4)` in the
    frames' pixels, `labels`, `scores`, `valid` (B, 100), and `stats`: the
    pyramid levels' RMS, the shares the NMS suppressed, the most candidates
    an image had for the class NMS."""
    levels = pyramid(w, images, config, precision)
    rois, roi_valid, stats = proposals(w, levels, config, precision)
    logits, deltas = box_logits(w, levels, rois, config, precision)
    out = detections(logits, deltas, rois, roi_valid, config)
    out["stats"].update(stats, level_rms=[float(f.square().mean().sqrt()) for f in levels])
    return out
