"""Faster R-CNN assembly, the counterpart of
`objectpermanence_tpu/models/detector/detector.py`: config, modules, the
inference forward and the video loop (training is `training.py`).

Shapes stay static as in JAX: frames are resized and zero-padded to a
fixed pyramid, proposals and detections are fixed-width tensors padded with
`NEG_INF` scores. Where JAX `vmap`s over the frames of a chunk, the port
runs the chunk as a batch dimension: NMS takes every (image, level) pair in
one call, RoIAlign every image in one launch (`ops/roi_align_kernel.py`:
K7, or K9 for the 800 px pyramid; in training K8 is the backward of
either), the box head every roi of the chunk in one product.

`compute_dtype="bfloat16"` runs the backbone, FPN and heads in bfloat16
with the parameters kept float32 (each layer casts them, `resnet.py`, and
in training the casts carry the gradient back to the float32 masters); the
image is resized in float32 first, the heads emit float32, and box decode,
top-k, NMS, postprocess, matching, sampling and the losses stay float32, as
in JAX. Training takes either dtype and every `roi_backend`: the RoIAlign
backward (K8) returns dF in the pyramid's dtype. The backbone runs NCHW,
cuDNN's own layout, and the RoIAlign kernels read P2-P5 in place through
their strides. On the H100 that is faster than a channels_last backbone,
around whose fp32 convolutions cuDNN transposes (PERF.md). TF32 is switched off
for matmuls and cuDNN.
"""

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.models.detector import anchors as anchor_lib
from objectpermanence_tpu_torch.models.detector.fpn import FPN
from objectpermanence_tpu_torch.models.detector.resnet import ResNet, out_channels
from objectpermanence_tpu_torch.models.detector.roi_heads import (
    ROI_STRIDES, RoIHeads, assign_levels, postprocess_detections,
)
from objectpermanence_tpu_torch.models.detector.rpn import RPNHead, generate_proposals
from objectpermanence_tpu_torch.ops.nms import NEG_INF
from objectpermanence_tpu_torch.ops.roi_align_kernel import (
    roi_align_batched, roi_align_trainable, roi_align_windowed, roi_align_windowed_trainable,
)
from objectpermanence_tpu_torch.ops.roi_align_window import contract_stats
from objectpermanence_tpu_torch.utils import trace

# the reference divides frames by 256 before the detector, then applies the
# ImageNet mean/std of the torchvision transform
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class DetectorConfig:
    """The JAX package's `DetectorConfig`, field for field."""
    num_classes: int = 193            # includes background slot 0
    image_hw: Tuple[int, int] = (240, 320)   # raw CATER frames (H, W)
    min_size: int = 800
    max_size: int = 1333
    backbone_layers: Tuple[int, ...] = (3, 4, 6, 3)
    backbone_width: int = 64
    backbone_norm: str = "frozen"     # "frozen" or "group"
    fpn_channels: int = 256
    anchor_sizes: Tuple[float, ...] = anchor_lib.DEFAULT_SIZES
    rpn_pre_nms_top_n: int = 1000
    rpn_post_nms_top_n: int = 1000
    rpn_nms_thresh: float = 0.7
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    # "bfloat16": backbone, FPN and heads in bf16 (params stay float32)
    compute_dtype: str = "float32"
    # "pallas" and "gather" run the exact RoIAlign (K7 on the card, the same
    # function JAX's gather computes), "windowed" K9; "auto" picks between
    # them by JAX's TPU rule (`roi_path`)
    roi_backend: str = "auto"

    @property
    def scale(self) -> float:
        h, w = self.image_hw
        return min(self.min_size / min(h, w), self.max_size / max(h, w))

    @property
    def resized_hw(self) -> Tuple[int, int]:
        h, w = self.image_hw
        return (int(round(h * self.scale)), int(round(w * self.scale)))

    @property
    def padded_hw(self) -> Tuple[int, int]:
        h, w = self.resized_hw
        return (math.ceil(h / 32) * 32, math.ceil(w / 32) * 32)

    @property
    def strides(self) -> Tuple[int, ...]:
        return (4, 8, 16, 32, 64)

    def feature_shapes(self) -> List[Tuple[int, int]]:
        h, w = self.padded_hw
        return [(math.ceil(h / s), math.ceil(w / s)) for s in self.strides]


def check_supported(config: DetectorConfig) -> None:
    """Raise on a compute dtype or RoIAlign backend that JAX's config does
    not name; every one it names runs in inference and in training."""
    if config.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {config.compute_dtype!r}")
    if config.roi_backend not in ("auto", "pallas", "gather", "windowed"):
        raise ValueError(f"roi_backend must be auto, pallas, gather or windowed, "
                         f"got {config.roi_backend!r}")


class BackboneWithFPN(nn.Module):
    """torchvision's `backbone`: `body` (ResNet) and `fpn`."""

    def __init__(self, config: DetectorConfig):
        super().__init__()
        self.body = ResNet(config.backbone_layers, config.backbone_width,
                           config.backbone_norm)
        self.fpn = FPN(out_channels(config.backbone_layers, config.backbone_width),
                       config.fpn_channels)

    def forward(self, x):
        return self.fpn(self.body(x))


class RPN(nn.Module):
    """torchvision's `rpn`, of which only the `head` holds weights."""

    def __init__(self, channels: int):
        super().__init__()
        self.head = RPNHead(channels, 3)


class Detector(nn.Module):
    """Faster R-CNN with torchvision's `fasterrcnn_resnet50_fpn` state_dict
    names (`backbone.body.*`, `backbone.fpn.*`, `rpn.head.*`,
    `roi_heads.box_head.*`, `roi_heads.box_predictor.*`)."""

    def __init__(self, config: DetectorConfig):
        super().__init__()
        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.backbone = BackboneWithFPN(config)
        self.rpn = RPN(config.fpn_channels)
        self.roi_heads = RoIHeads(config.fpn_channels, 7, 1024, config.num_classes)


@torch.no_grad()
def init_detector(model: Detector, seed: int = 0) -> Detector:
    """Seeded random weights with the JAX package's distributions (its own
    numbers come from `jax.random` and cannot be reproduced): He-normal
    (fan_out) convolutions, RPN head normal(0.01), fc6/fc7 uniform
    +-sqrt(1/fan_in), the predictor normal(0.01)/normal(0.001), zero biases
    and identity norms."""
    gen = torch.Generator().manual_seed(seed)
    for name, module in model.named_modules():
        if isinstance(module, nn.Conv2d):
            cout, _, kh, kw = module.weight.shape
            std = 0.01 if name.startswith("rpn.") else math.sqrt(2.0 / (kh * kw * cout))
            module.weight.copy_(torch.randn(module.weight.shape, generator=gen) * std)
        elif isinstance(module, nn.Linear):
            fan_in = module.weight.shape[1]
            if name.endswith(("fc6", "fc7")):
                limit = math.sqrt(1.0 / fan_in)
                module.weight.copy_(torch.rand(module.weight.shape, generator=gen)
                                    * (2 * limit) - limit)
            else:
                std = 0.01 if name.endswith("cls_score") else 0.001
                module.weight.copy_(torch.randn(module.weight.shape, generator=gen) * std)
        else:
            continue
        if module.bias is not None:
            module.bias.zero_()
    return model


def preprocess_images(images: torch.Tensor, config: DetectorConfig) -> torch.Tensor:
    """uint8/float RGB (B, H0, W0, 3) -> normalized, resized, zero-padded
    (B, 3, Hp, Wp). The resize is bilinear with half-pixel centers and, when
    shrinking, the triangle filter widened to the scale, as
    `jax.image.resize(..., "bilinear")`; at scale 1 (native CATER frames) it
    is skipped, where JAX's is the identity."""
    x = images.to(torch.float32) / 256.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    # contiguous NCHW: a permuted view would carry its NHWC strides into the
    # convolutions, which would then run channels_last
    x = ((x - mean) / std).permute(0, 3, 1, 2).contiguous()
    rh, rw = config.resized_hw
    if (rh, rw) != tuple(x.shape[-2:]):
        x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False,
                          antialias=True)
    ph, pw = config.padded_hw
    return F.pad(x, (0, pw - rw, 0, ph - rh))


def forward_features(model: Detector, images_prepped: torch.Tensor) -> List[torch.Tensor]:
    """Backbone + FPN over the float32 preprocessed images, in the model's
    compute dtype -> [P2..P6], each (B, C, H_l, W_l)."""
    return model.backbone(images_prepped.to(model.compute_dtype))


def propose(model: Detector, pyramid: List[torch.Tensor], config: DetectorConfig,
            anchors: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    objectness, deltas = model.rpn.head(pyramid)
    return generate_proposals([torch.sigmoid(o) for o in objectness], deltas, anchors,
                              config.padded_hw, config.rpn_pre_nms_top_n,
                              config.rpn_post_nms_top_n, config.rpn_nms_thresh)


RESIDENT_BYTES = 8 * 2 ** 20  # JAX's VMEM test for K7's resident pyramid


def roi_path(config: DetectorConfig, device: torch.device, needs_grad: bool) -> str:
    """"exact" (K7, with K8 for a gradient) or "windowed" (K9): JAX's
    `_use_pallas_roi` with the card in the TPU's place. "windowed" asks
    for K9, "pallas" and "gather" for the exact function. "auto" is exact
    off the card, and on it where K7's TPU kernel ran: a channel count that
    is a multiple of 128 and P2-P5 of one image within 8 MiB of float32
    (the native 240 x 320 geometry); a larger pyramid (the 800 px recipe)
    takes K9 in inference and the exact pair when a gradient is needed."""
    if config.roi_backend == "windowed":
        return "windowed"
    if config.roi_backend != "auto" or device.type != "cuda" or config.fpn_channels % 128:
        return "exact"
    h, w = config.padded_hw
    positions = sum(math.ceil(h / s) * math.ceil(w / s) for s in ROI_STRIDES)
    if positions * config.fpn_channels * 4 <= RESIDENT_BYTES or needs_grad:
        return "exact"
    return "windowed"


def batched_roi_align(pyramid: List[torch.Tensor], proposals: torch.Tensor,
                      config: DetectorConfig) -> torch.Tensor:
    """P2..P5 (B, C, H_l, W_l) + proposals (B, N, 4) -> (B, N, C, 7, 7) in
    the pyramid's dtype: each roi pooled from its assigned level, by the
    kernel `roi_path` picks on the card (K7, `roi_align_pallas_batched` in
    JAX, or K9, `roi_align_pallas_windowed`) and by its plain version on the
    CPU. When a gradient is recorded for the pyramid, through the autograd
    Function whose backward is K8 (for K9, `roi_align_windowed_trainable`);
    the proposals get none."""
    needs_grad = torch.is_grad_enabled() and any(p.requires_grad for p in pyramid)
    check_supported(config)
    levels = assign_levels(proposals)
    path = roi_path(config, proposals.device, needs_grad)
    if path == "windowed" and needs_grad:
        pooled = roi_align_windowed_trainable(pyramid, proposals, levels, ROI_STRIDES)
    elif path == "windowed":
        pooled = roi_align_windowed(pyramid, proposals, levels, ROI_STRIDES)
    elif needs_grad:
        pooled = roi_align_trainable(pyramid, proposals, levels, ROI_STRIDES)
    else:
        pooled = roi_align_batched(pyramid, proposals, levels, ROI_STRIDES)
    return pooled.to(pyramid[0].dtype)


def detect_forward(model: Detector, images: torch.Tensor, config: DetectorConfig,
                   anchors: List[torch.Tensor]):
    """Raw frames (B, H, W, 3) -> boxes (B, D, 4) in the frames' own
    coordinates, labels (B, D), scores (B, D), valid (B, D)."""
    device = images.device
    with trace.span("objperm.detector.backbone", device):
        prepped = preprocess_images(images, config)
        pyramid = forward_features(model, prepped)
    with trace.span("objperm.detector.proposals", device):
        proposals, prop_scores = propose(model, pyramid, config, anchors)
    with trace.span("objperm.detector.heads", device):
        pooled = batched_roi_align(pyramid[:4], proposals, config)
        cls_logits, box_deltas = model.roi_heads(pooled)
        boxes, labels, scores = postprocess_detections(
            cls_logits, box_deltas, proposals, prop_scores, config.padded_hw,
            config.score_thresh, config.nms_thresh, config.detections_per_img)
    boxes = boxes / config.scale  # back to the frames' coordinates
    return boxes, labels, scores, scores > NEG_INF / 10


class CaterDetector:
    """The detector for videos (the reference's `CaterObjectDetector`):
    weights loaded once, frames run in fixed-size chunks on `device` (the
    card unless "cpu")."""

    def __init__(self, config: Optional[DetectorConfig] = None, state_dict=None,
                 device=None, seed: int = 0):
        self.config = config or DetectorConfig()
        check_supported(self.config)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = Detector(self.config)
        if state_dict is None:
            init_detector(model, seed)
        else:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.anchors = [torch.from_numpy(a).to(self.device) for a in anchor_lib.pyramid_anchors(
            self.config.feature_shapes(), self.config.strides, self.config.anchor_sizes)]

    @classmethod
    def load(cls, checkpoint_path, config: Optional[DetectorConfig] = None,
             device=None) -> "CaterDetector":
        """Seeded random weights for None; a `.npz` written by
        `utils.checkpoint.save_params`; or a torchvision `.pth`/`.pt` state_dict
        (raw or the reference's `{"model_state_dict": ...}`)."""
        if not checkpoint_path:
            return cls(config, device=device)
        path = str(checkpoint_path)
        if path.endswith((".pth", ".pt")):
            from objectpermanence_tpu_torch.models.detector.convert import load_torch_checkpoint
            state_dict = load_torch_checkpoint(path)
        else:
            from objectpermanence_tpu_torch.utils.checkpoint import load_params
            state_dict = load_params(path)
        det = cls(config, state_dict=state_dict, device=device)
        print(f"Loaded detector parameters from {checkpoint_path}")
        return det

    @torch.inference_mode()
    def __call__(self, frames):
        """frames (B, H, W, 3) RGB -> (boxes, labels, scores, valid) as numpy.
        Then reads the windowed RoIAlign's contract counts, which warns once
        on the first out-of-contract roi (the outputs' copy has synchronised
        the card already). The frames' copy to the card and the outputs'
        copies back are blocking copies (`objperm.host.h2d`, `.d2h`)."""
        frames = torch.as_tensor(np.asarray(frames))
        with trace.h2d(frames, self.device):
            images = frames.to(self.device)
        out = detect_forward(self.model, images, self.config, self.anchors)
        with trace.d2h(*out):
            result = tuple(o.cpu().numpy() for o in out)
        contract_stats()
        return result

    @torch.inference_mode()
    def detect_video(self, frames: np.ndarray, batch_size: int = 16):
        """All frames of one video, `batch_size` at a time -> (boxes, labels,
        scores, valid) numpy arrays over every frame, as `__call__` gives
        them chunk by chunk. The video goes to the card in one blocking copy
        (`objperm.host.h2d`), the chunks' forwards are queued one after
        another with nothing read between them, and each output comes back
        in one blocking copy (`objperm.host.d2h`), so the card does not wait
        on the host between chunks. Then reads the windowed RoIAlign's
        contract counts, as `__call__` does. One root span,
        `objperm.detect.video`, whose id its chunks' spans share."""
        with trace.span("objperm.detect.video"):
            video = torch.as_tensor(np.asarray(frames))
            with trace.h2d(video, self.device):
                video = video.to(self.device)
            chunks = [detect_forward(self.model, video[start:start + batch_size], self.config,
                                     self.anchors)
                      for start in range(0, len(video), batch_size)]
            out = [torch.cat(parts) for parts in zip(*chunks)]
            with trace.d2h(*out):
                result = tuple(o.cpu().numpy() for o in out)
            contract_stats()
        return result
