"""The Faster R-CNN R50-FPN detector's adapter: the port's `CaterDetector`
built as `infer/preprocess.py::preprocess_main` builds it, holding the
benchmark's weights.

Every weight is one uniform leaf of `make_weights`' single draw. A leaf's
initialiser may carry a third number, its centre: `("uniform", k, c)` is
U(c - k, c + k), the draw shifted by `c` after it is made (the frozen
norms' scales and variances sit around 1). The scales of `SCALES` were set
once, on the CPU at the published widths, so that random weights do a
detector's work on the painted frames: each pyramid level's RMS within
10x of 1 and objectness spread so that the RPN's NMS suppresses. One
number is set per seed, on the seed's frames: the background class's
bias (`calibrate`, then `reload` into the built detector), so that a
frame has about as many detections at or above 0.8 as the ingest cache
has visible objects (`configs/faster_rcnn_r50_fpn.json`, `assumed`).
"""

import math

import torch

from benchmark.models import UNIFORM, make_weights

CLS = "roi_heads.box_predictor.cls_score"
CALIBRATION_RANGE = 64.0   # the background bias is sought in +-64,
CALIBRATION_STEP = 2.0     # scanned down in steps of 2,
CALIBRATION_BISECTIONS = 8  # then bisected to 2 / 2**8
# the configuration's keys that are `DetectorConfig` fields, set beside the
# shipped preprocess config as a user of `preprocess` sets them
DETECTOR_KEYS = ("num_classes", "backbone_layers", "backbone_width", "backbone_norm",
                 "fpn_channels", "anchor_sizes", "rpn_nms_thresh", "score_thresh", "nms_thresh",
                 "detections_per_img")

# each convolution and linear layer's bound as a multiple of sqrt(3 / fan_in),
# the bound that keeps a product's variance; biases and norms absolute
SCALES = {
    "conv": math.sqrt(2.0),        # a convolution before a ReLU (He)
    "branch_out": 1.0,             # a bottleneck's conv3 and its shortcut
    "norm_scale": 0.1,             # frozen norm: weight 1 +- 0.1
    "branch_norm": 0.5,            # bn3 and the shortcut's norm: weight centred at 0.5
    "norm_shift": 0.1,             # bias and running_mean +- 0.1
    "norm_var": 0.25,              # running_var 1 +- 0.25
    "fpn": 1.0,
    "fpn_bias": 0.1,
    "rpn_conv": math.sqrt(2.0),
    "rpn_logits": 2.0,
    "rpn_deltas": 0.1,
    "fc": math.sqrt(2.0),
    "fc_bias": 0.01,
    "cls_score": 8.0,
    "box_deltas": 0.5,
}


def _bound(scale, fan_in):
    return scale * math.sqrt(3.0 / fan_in)


def leaves(config):
    """Every weight of `fasterrcnn_resnet50_fpn` with 193 classes, under the
    port's (torchvision's) state_dict names, in state_dict order."""
    s = SCALES
    out = []

    def conv(name, cout, cin, k, scale, bias=None):
        out.append((f"{name}.weight", (cout, cin, k, k), (UNIFORM, _bound(scale, cin * k * k))))
        if bias is not None:
            out.append((f"{name}.bias", (cout,), (UNIFORM, bias)))

    def norm(name, c, centre=1.0):
        out.extend([(f"{name}.weight", (c,), (UNIFORM, s["norm_scale"] * centre, centre)),
                    (f"{name}.bias", (c,), (UNIFORM, s["norm_shift"])),
                    (f"{name}.running_mean", (c,), (UNIFORM, s["norm_shift"])),
                    (f"{name}.running_var", (c,), (UNIFORM, s["norm_var"], 1.0))])

    width, body = config["backbone_width"], "backbone.body"
    conv(f"{body}.conv1", width, 3, 7, s["conv"])
    norm(f"{body}.bn1", width)
    cin = width
    for stage, blocks in enumerate(config["backbone_layers"]):
        mid = width * 2 ** stage
        for b in range(blocks):
            p = f"{body}.layer{stage + 1}.{b}"
            conv(f"{p}.conv1", mid, cin, 1, s["conv"])
            norm(f"{p}.bn1", mid)
            conv(f"{p}.conv2", mid, mid, 3, s["conv"])
            norm(f"{p}.bn2", mid)
            conv(f"{p}.conv3", 4 * mid, mid, 1, s["branch_out"])
            norm(f"{p}.bn3", 4 * mid, s["branch_norm"])
            if b == 0:
                conv(f"{p}.downsample.0", 4 * mid, cin, 1, s["branch_out"])
                norm(f"{p}.downsample.1", 4 * mid, s["branch_norm"])
            cin = 4 * mid
    fpn = config["fpn_channels"]
    stages = len(config["backbone_layers"])
    for i in range(stages):
        conv(f"backbone.fpn.inner_blocks.{i}", fpn, width * 2 ** i * 4, 1, s["fpn"], s["fpn_bias"])
    for i in range(stages):
        conv(f"backbone.fpn.layer_blocks.{i}", fpn, fpn, 3, s["fpn"], s["fpn_bias"])
    anchors = config["anchors_per_position"]
    conv("rpn.head.conv", fpn, fpn, 3, s["rpn_conv"], 0.0)
    conv("rpn.head.cls_logits", anchors, fpn, 1, s["rpn_logits"], 0.0)
    conv("rpn.head.bbox_pred", 4 * anchors, fpn, 1, s["rpn_deltas"], 0.0)
    rep, pooled, classes = config["representation_size"], config["roi_output_size"], \
        config["num_classes"]

    def linear(name, fout, fin, scale, bias):
        out.extend([(f"{name}.weight", (fout, fin), (UNIFORM, _bound(scale, fin))),
                    (f"{name}.bias", (fout,), (UNIFORM, bias))])

    linear("roi_heads.box_head.fc6", rep, fpn * pooled * pooled, s["fc"], s["fc_bias"])
    linear("roi_heads.box_head.fc7", rep, rep, s["fc"], s["fc_bias"])
    linear("roi_heads.box_predictor.cls_score", classes, rep, s["cls_score"], 0.0)
    linear("roi_heads.box_predictor.bbox_pred", 4 * classes, rep, s["box_deltas"], 0.0)
    return out


def weights(config, seed, device):
    """The benchmark's weights for `config`: one draw, each leaf moved to
    its centre, and each row of the class scores less its mean: the box
    head's features are ReLU outputs, whose common positive part would
    otherwise give every roi the class whose row sums highest. The
    background's bias is left 0 for `calibrate`."""
    specs = leaves(config)
    out = make_weights(specs, seed, device)
    for name, _, init in specs:
        if len(init) > 2:
            out[name].add_(init[2])
    scores = out[CLS + ".weight"]
    scores.sub_(scores.mean(1, keepdim=True))
    return out


def calibrate(config, weights, frames, target):
    """Set the background class's bias (`weights`, in place) to the largest
    value at which the reference finds `target` detections at or above the
    kept score a frame on `frames` -> the bias. Random weights give no class
    a meaning, and the features' scale varies from seed to seed by more than
    the scores' thresholds allow: at one fixed bias the count of kept
    detections ranged from 0.5 to 96 a frame over eight seeds (on the CPU,
    at the published widths). The count falls as the bias rises, but not
    strictly (a detection that suppressed another can drop out first), so
    the bias is scanned down from the top in steps, then bisected within
    the step where the count first reaches `target`: the largest such bias
    leaves the fewest candidates to the class NMS. The reference's forward
    runs a chunk of the configuration's batch at a time."""
    from benchmark.reference import faster_rcnn_r50_fpn as reference

    chunk = config["preprocess_config"]["batch_size"]
    parts = []
    with torch.no_grad():
        for start in range(0, len(frames), chunk):
            levels = reference.pyramid(weights, frames[start:start + chunk], config)
            rois, roi_valid, _ = reference.proposals(weights, levels, config)
            parts.append((*reference.box_logits(weights, levels, rois, config), rois, roi_valid))
            del levels
    logits, deltas, rois, roi_valid = (torch.cat(p) for p in zip(*parts))

    def reaches(bias):
        shifted = logits.clone()
        shifted[..., 0] += bias
        out = reference.detections(shifted, deltas, rois, roi_valid, config)
        kept = out["valid"] & (out["scores"] >= config["kept_score"])
        return float(kept.sum()) / len(frames) >= target

    high = CALIBRATION_RANGE
    while high > -CALIBRATION_RANGE and not reaches(high - CALIBRATION_STEP):
        high -= CALIBRATION_STEP
    low = high - CALIBRATION_STEP
    for _ in range(CALIBRATION_BISECTIONS):
        middle = (low + high) / 2
        low, high = (middle, high) if reaches(middle) else (low, middle)
    weights[CLS + ".bias"][0] = low
    return low


def reload(detector, weights):
    """Copy `weights` into the detector that `build` made."""
    detector.model.load_state_dict(weights, strict=True)


def preprocess_config(config):
    """The preprocess config a user runs: the shipped one with the
    architecture's `DetectorConfig` fields set beside it."""
    return {**config["preprocess_config"], **{k: config[k] for k in DETECTOR_KEYS}}


def build(config, state_dict, device):
    """-> (the port's `CaterDetector`, the chunk of frames a call runs), made
    as `preprocess_main` makes them."""
    from objectpermanence_tpu_torch.config import preprocess_config_from
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig

    cfg, overrides = preprocess_config_from(preprocess_config(config))
    return CaterDetector(DetectorConfig(**overrides), state_dict=state_dict,
                         device=device), cfg.batch_size


def padded_hw(config):
    """The frame padded to multiples of 32 (240 x 320 -> 256 x 320)."""
    h, w = config["image_hw"]
    p = config["preprocess_config"]
    scale = min(p["min_size"] / min(h, w), p["max_size"] / max(h, w))
    return tuple(math.ceil(round(d * scale) / 32) * 32 for d in (h, w))


def flops_per_frame(config):
    """Two operations a multiply-add of every convolution and linear layer
    of the forward, one frame: the backbone and FPN over the padded frame,
    the RPN head over P2-P6, and the box head and predictor over the
    `rpn_post_nms_top_n` proposals. Norms, biases, pooling, RoIAlign, NMS
    and the decodes are not counted (39.66 GFLOP at the published widths)."""
    h, w = padded_hw(config)
    width, fpn = config["backbone_width"], config["fpn_channels"]

    def out_hw(stride):
        return math.ceil(h / stride) * math.ceil(w / stride)

    flops = 2 * 3 * 49 * width * out_hw(2)          # conv1, stride 2
    cin = width
    for stage, blocks in enumerate(config["backbone_layers"]):
        mid, stride = width * 2 ** stage, 4 * 2 ** stage
        before = out_hw(max(stride // 2, 4))         # a stage's first conv1 runs before its stride
        for b in range(blocks):
            flops += 2 * cin * mid * (before if b == 0 else out_hw(stride))
            flops += 2 * 9 * mid * mid * out_hw(stride) + 2 * mid * 4 * mid * out_hw(stride)
            if b == 0:
                flops += 2 * cin * 4 * mid * out_hw(stride)
            cin = 4 * mid
    levels = [out_hw(4 * 2 ** i) for i in range(len(config["backbone_layers"]))]
    flops += sum(2 * width * 2 ** i * 4 * fpn * n for i, n in enumerate(levels))  # laterals
    flops += sum(2 * 9 * fpn * fpn * n for n in levels)                         # outputs
    positions = sum(levels) + out_hw(64)                                         # P2-P6
    a = config["anchors_per_position"]
    flops += positions * (2 * 9 * fpn * fpn + 2 * fpn * a + 2 * fpn * 4 * a)
    rep, classes = config["representation_size"], config["num_classes"]
    head = fpn * config["roi_output_size"] ** 2 * rep + rep * rep + rep * classes + rep * 4 * classes
    return flops + 2 * head * config["preprocess_config"]["rpn_post_nms_top_n"]


def visible_objects_per_frame(cache):
    """The frozen ingest cache's mean count of visible objects a frame."""
    return float((cache["boxes"][..., 4] > 0.5).sum(-1).mean())
