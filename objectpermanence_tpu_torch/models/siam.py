"""SiamRPN visual tracker (the DaSiamRPN family), the counterpart of
`objectpermanence_tpu/models/siam.py`.

The reference vendors the tracker (`baselines/DaSiamRPN/code/net.py`,
`run_SiamRPN.py`): an AlexNet-style siamese feature extractor whose
template branch turns the exemplar into per-anchor correlation kernels;
tracking cross-correlates the search crop's features with those kernels
into 19x19 (or 21x21) score and regression maps.

Split as in JAX:
- the network (`SiamRPN`, an `nn.Module` on the card) runs the convs, the
  correlation (`F.conv2d` with the template's kernels, as XLA's conv is in
  JAX: no Pallas kernel computes it) and the softmax;
- the frame-sequential crop, anchor decode, penalty and window logic stays
  host numpy, the same math as JAX's: `generate_anchor`, `get_subwindow`,
  `tracker_update`.

`get_subwindow` resizes crops with `resize_linear_u8`, a numpy replica of
cv2's uint8 `INTER_LINEAR`, so the tracker runs where cv2 is missing.

Weights: the module's state_dict has the upstream `SiamRPNvot` names
(`featureExtract.<i>.weight`, `conv_r1.weight`, ...), so the upstream
`SiamRPNVOT.model` blob loads as it is; `models/convert.py::
siam_params_from_jax` carries a JAX parameter tree over, and
`train/siam_loop.py::siam_train_main` writes `.npz` checkpoints.
"""

import math
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.models.heuristic import AbstractReasoner, get_label_bb
from objectpermanence_tpu_torch.vocab import SNITCH_CLASS_INDEX

# SiamRPNvot: size=1, feature_out=256 (reference `net.py:69-72`)
FEATURE_CHANNELS = (3, 96, 256, 384, 384, 256)
FEATURE_OUT = 256
NUM_ANCHORS = 5
BN_EPS = 1e-5
# (conv, batch norm) indices in the upstream `featureExtract` Sequential
FEATURE_LAYERS = ((0, 1), (4, 5), (8, 9), (11, 12), (14, 15))
HEADS = ("conv_r1", "conv_r2", "conv_cls1", "conv_cls2", "regress_adjust")

VOT_CFG = {"lr": 0.45, "window_influence": 0.44, "penalty_k": 0.04,
           "instance_size": 271, "adaptive": False}


# ---------------------------------------------------------------------------
# Network (NCHW, as the upstream weights)
# ---------------------------------------------------------------------------

class FoldedBatchNorm(nn.Module):
    """Batch norm as JAX's `_bn` folds it: `x * w + b` with `w = weight /
    sqrt(running_var + eps)` and `b = bias - running_mean * w`. Its names
    are `nn.BatchNorm2d`'s, without `num_batches_tracked`; `forward` always
    uses the running statistics (training computes batch statistics in
    `train/siam_loop.py`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def fold(self, mean: torch.Tensor, var: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * torch.rsqrt(var + BN_EPS)
        b = self.bias - mean * w
        return x * w[None, :, None, None] + b[None, :, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fold(self.running_mean, self.running_var, x)


def _conv_init(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """Kaiming-normal weights (std sqrt(2 / fan_in)), zero bias, as JAX's
    `_conv_init`; drawn from `generator`, so not JAX's values."""
    cout, cin, kh, kw = conv.weight.shape
    std = math.sqrt(2.0 / (cin * kh * kw))
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator) * std)
        if conv.bias is not None:
            conv.bias.zero_()


class SiamRPN(nn.Module):
    """The SiamRPNvot network: `featureExtract` (five conv + batch-norm
    layers, 3x3/2 max-pools after the first two), the template heads
    `conv_r1`/`conv_cls1`, the search heads `conv_r2`/`conv_cls2` and the 1x1
    `regress_adjust`. Seeded from `generator` (default: seed 0)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = FEATURE_CHANNELS
        self.featureExtract = nn.Sequential(
            nn.Conv2d(c[0], c[1], 11, stride=2, bias=False), FoldedBatchNorm(c[1]),
            nn.MaxPool2d(3, 2), nn.ReLU(),
            nn.Conv2d(c[1], c[2], 5, bias=False), FoldedBatchNorm(c[2]),
            nn.MaxPool2d(3, 2), nn.ReLU(),
            nn.Conv2d(c[2], c[3], 3, bias=False), FoldedBatchNorm(c[3]), nn.ReLU(),
            nn.Conv2d(c[3], c[4], 3, bias=False), FoldedBatchNorm(c[4]), nn.ReLU(),
            nn.Conv2d(c[4], c[5], 3, bias=False), FoldedBatchNorm(c[5]),
        )
        self.conv_r1 = nn.Conv2d(c[5], FEATURE_OUT * 4 * NUM_ANCHORS, 3)
        self.conv_r2 = nn.Conv2d(c[5], FEATURE_OUT, 3)
        self.conv_cls1 = nn.Conv2d(c[5], FEATURE_OUT * 2 * NUM_ANCHORS, 3)
        self.conv_cls2 = nn.Conv2d(c[5], FEATURE_OUT, 3)
        self.regress_adjust = nn.Conv2d(4 * NUM_ANCHORS, 4 * NUM_ANCHORS, 1)
        generator = generator or torch.Generator().manual_seed(0)
        for conv_i, _ in FEATURE_LAYERS:
            _conv_init(self.featureExtract[conv_i], generator)
        for name in HEADS:
            _conv_init(getattr(self, name), generator)

    def feature_layers(self):
        """[(conv, batch norm)] of the five feature layers, in order."""
        return [(self.featureExtract[c], self.featureExtract[b]) for c, b in FEATURE_LAYERS]

    def feature_extract(self, x: torch.Tensor, norm=None) -> torch.Tensor:
        """x (B, 3, S, S) float -> (B, 256, s, s). `norm(layer_index, bn, y)`
        replaces the frozen batch norm (training passes batch statistics)."""
        norm = norm or (lambda i, bn, y: bn(y))
        layers = self.feature_layers()
        y = norm(0, layers[0][1], layers[0][0](x))
        y = F.relu(F.max_pool2d(y, 3, 2))
        y = norm(1, layers[1][1], layers[1][0](y))
        y = F.relu(F.max_pool2d(y, 3, 2))
        y = F.relu(norm(2, layers[2][1], layers[2][0](y)))
        y = F.relu(norm(3, layers[3][1], layers[3][0](y)))
        return norm(4, layers[4][1], layers[4][0](y))

    def template_kernels(self, z_f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exemplar features (B, 256, 6, 6) -> per-sample correlation
        kernels (B, 20, 256, 4, 4) and (B, 10, 256, 4, 4)."""
        r1 = self.conv_r1(z_f)
        cls1 = self.conv_cls1(z_f)
        b, k = z_f.shape[0], r1.shape[-1]
        return (r1.reshape(b, NUM_ANCHORS * 4, FEATURE_OUT, k, k),
                cls1.reshape(b, NUM_ANCHORS * 2, FEATURE_OUT, k, k))

    def temple(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exemplar crop (1, 3, 127, 127) -> correlation kernels
        (r1 (20, 256, 4, 4), cls1 (10, 256, 4, 4))."""
        r1, cls1 = self.template_kernels(self.feature_extract(z))
        return r1[0], cls1[0]

    def track_forward(self, kernels, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Search crop (1, 3, S, S) -> (delta (4, A*s*s), score_fg (A*s*s,)),
        flattened in the reference's channel-major order
        (`run_SiamRPN.py:70-71`): a row-major reshape of the (4A, s, s) map
        to (4, A*s*s), so channel c = coord * A + anchor and an anchor's
        index in a row is a*s*s + spatial, `generate_anchor`'s layout."""
        r1_kernel, cls1_kernel = kernels
        x_f = self.feature_extract(x)
        delta = F.conv2d(self.conv_r2(x_f), r1_kernel)
        delta = self.regress_adjust(delta)
        score = F.conv2d(self.conv_cls2(x_f), cls1_kernel)
        delta = delta[0].reshape(4, -1)
        score = score[0].reshape(2, -1)
        return delta, torch.softmax(score, dim=0)[1]


# ---------------------------------------------------------------------------
# Host-side tracker math (numpy, the same as JAX's)
# ---------------------------------------------------------------------------

def generate_anchor(total_stride: int, scales, ratios, score_size: int) -> np.ndarray:
    """(A * score_size^2, 4) cx/cy/w/h anchors (reference
    `run_SiamRPN.py:14-39`, with its int truncation)."""
    anchor_num = len(ratios) * len(scales)
    anchor = np.zeros((anchor_num, 4), np.float32)
    size = total_stride * total_stride
    count = 0
    for ratio in ratios:
        ws = int(np.sqrt(size / ratio))
        hs = int(ws * ratio)
        for scale in scales:
            anchor[count, 2] = ws * scale
            anchor[count, 3] = hs * scale
            count += 1
    anchor = np.tile(anchor, score_size * score_size).reshape((-1, 4))
    ori = -(score_size / 2) * total_stride
    grid = [ori + total_stride * d for d in range(score_size)]
    xx, yy = np.meshgrid(grid, grid)
    anchor[:, 0] = np.tile(xx.flatten(), (anchor_num, 1)).flatten()
    anchor[:, 1] = np.tile(yy.flatten(), (anchor_num, 1)).flatten()
    return anchor


def _linear_taps(src: int, dst: int):
    """cv2's uint8 INTER_LINEAR taps along one axis: source indices (i0, i1)
    and 11-bit weights (w0, w1). The source coordinate is (d + 0.5) / scale
    - 0.5 in float32; its floor is clamped to the edges while the fraction
    keeps its value (so an edge row blends one source row with itself)."""
    scale = 1.0 / (np.float64(dst) / np.float64(src))
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear_u8(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """`cv2.resize(image, (width, height))` for a uint8 (H, W, C) image,
    bilinear, in cv2's fixed point: a horizontal pass with 11-bit weights in
    integers, then a vertical pass as its vector code rounds,
    `(((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2) >> 2`. Equal to
    cv2 5.0's output, bit for bit, on the crops the tracker makes
    (tests/test_torch_siam.py)."""
    if image.dtype != np.uint8 or image.ndim != 3:
        raise TypeError(f"resize_linear_u8 takes a uint8 (H, W, C) image, got "
                        f"{image.dtype} {image.shape}")
    h, w, c = image.shape
    x0, x1, a0, a1 = _linear_taps(w, width)
    y0, y1, b0, b1 = _linear_taps(h, height)
    im = image.astype(np.int64)
    rows = im[:, x0] * a0[None, :, None] + im[:, x1] * a1[None, :, None]     # (h, width, c)
    out = ((((rows[y0] >> 4) * b0[:, None, None]) >> 16)
           + (((rows[y1] >> 4) * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def get_subwindow(im: np.ndarray, pos, original_sz: int, model_sz: int,
                  avg_chans: np.ndarray) -> np.ndarray:
    """The square crop of side `original_sz` centred at `pos`, padded with
    `avg_chans` beyond the frame, resized to `model_sz` (reference
    `utils.py:47-90`)."""
    original_sz = max(int(original_sz), 2)  # degenerate-crop guard
    c = (original_sz + 1) / 2
    context_xmin = round(pos[0] - c)
    context_xmax = context_xmin + original_sz - 1
    context_ymin = round(pos[1] - c)
    context_ymax = context_ymin + original_sz - 1
    h, w = im.shape[:2]
    left_pad = int(max(0.0, -context_xmin))
    top_pad = int(max(0.0, -context_ymin))
    right_pad = int(max(0.0, context_xmax - w + 1))
    bottom_pad = int(max(0.0, context_ymax - h + 1))

    if any([top_pad, bottom_pad, left_pad, right_pad]):
        padded = np.empty((h + top_pad + bottom_pad, w + left_pad + right_pad, 3), im.dtype)
        padded[:] = avg_chans
        padded[top_pad:top_pad + h, left_pad:left_pad + w] = im
        im = padded
        context_xmin += left_pad
        context_xmax += left_pad
        context_ymin += top_pad
        context_ymax += top_pad

    patch = im[int(context_ymin):int(context_ymax + 1),
               int(context_xmin):int(context_xmax + 1)]
    if patch.shape[0] != model_sz:
        patch = resize_linear_u8(patch, model_sz, model_sz)
    return patch


def penalized_scores(delta: np.ndarray, score: np.ndarray, anchors: np.ndarray,
                     window: np.ndarray, target_sz_scaled: np.ndarray, penalty_k: float,
                     window_influence: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (decoded boxes (4, N) cx/cy/w/h, penalty (N,), penalized score (N,)):
    the anchor decode, the scale and ratio change penalty and the cosine
    window of `tracker_update`, whose arg-max picks the new box. JAX's clamps:
    the log-size regressions clipped at 20 before `exp`, the decoded and
    target sizes floored at 1e-12, the ratio as a product."""
    decoded = np.empty_like(delta)
    decoded[0] = delta[0] * anchors[:, 2] + anchors[:, 0]
    decoded[1] = delta[1] * anchors[:, 3] + anchors[:, 1]
    decoded[2] = np.exp(np.minimum(delta[2], 20.0)) * anchors[:, 2]
    decoded[3] = np.exp(np.minimum(delta[3], 20.0)) * anchors[:, 3]

    def change(r):
        # r can underflow to exactly 0.0 for degenerate candidates
        return np.maximum(r, 1.0 / np.maximum(r, np.float32(1e-30)))

    def sz(w, h):
        pad = (w + h) * 0.5
        return np.sqrt((w + pad) * (h + pad))

    eps = np.float32(1e-12)
    dw = np.maximum(decoded[2], eps)
    dh = np.maximum(decoded[3], eps)
    tw = max(target_sz_scaled[0], eps)
    th = max(target_sz_scaled[1], eps)

    s_c = change(sz(dw, dh) / sz(tw, th))
    r_c = change((tw * dh) / (th * dw))
    penalty = np.exp(-(r_c * s_c - 1.0) * penalty_k)
    pscore = penalty * score
    pscore = pscore * (1 - window_influence) + window * window_influence
    return decoded, penalty, pscore


def tracker_update(delta: np.ndarray, score: np.ndarray, anchors: np.ndarray,
                   window: np.ndarray, target_pos: np.ndarray,
                   target_sz_scaled: np.ndarray, scale_z: float,
                   penalty_k: float, window_influence: float, lr_factor: float
                   ) -> Tuple[np.ndarray, np.ndarray, float]:
    """The best penalized anchor's box and the smoothed size update
    (reference `tracker_eval`, `run_SiamRPN.py:67-114`) -> (new pos, new
    size, the best anchor's score)."""
    decoded, penalty, pscore = penalized_scores(delta, score, anchors, window,
                                                target_sz_scaled, penalty_k, window_influence)
    best = int(np.argmax(pscore))

    target = decoded[:, best] / scale_z
    target_sz = target_sz_scaled / scale_z
    lr = penalty[best] * score[best] * lr_factor

    new_pos = np.array([target[0] + target_pos[0], target[1] + target_pos[1]])
    new_sz = np.array([target_sz[0] * (1 - lr) + target[2] * lr,
                       target_sz[1] * (1 - lr) + target[3] * lr])
    return new_pos, new_sz, float(score[best])


@dataclass
class SiamState:
    pos: np.ndarray
    sz: np.ndarray
    kernels: Tuple
    window: np.ndarray
    anchors: np.ndarray
    avg_chans: np.ndarray
    instance_size: int
    im_hw: Tuple[int, int]
    score: float = 0.0


def _crop_tensor(crop: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 (S, S, 3) crop -> float32 (1, 3, S, S) on the device."""
    return torch.from_numpy(np.ascontiguousarray(crop.transpose(2, 0, 1)[None])).to(
        device).float()


class SiamRPNTracker:
    """Stateful host loop around the network (exemplar init and per-frame
    track), mirroring `SiamRPN_init`/`SiamRPN_track`. The network runs on
    `device` (the card unless "cpu"), with TF32 off there."""

    EXEMPLAR = 127
    STRIDE = 8
    CONTEXT = 0.5
    RATIOS = (0.33, 0.5, 1, 2, 3)
    SCALES = (8,)

    def __init__(self, model: Optional[SiamRPN] = None, cfg: Optional[dict] = None,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = model if model is not None else SiamRPN(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.cfg = dict(VOT_CFG, **(cfg or {}))

    def init(self, im: np.ndarray, target_pos, target_sz) -> SiamState:
        target_pos = np.asarray(target_pos, np.float64)
        # degenerate-size guard: an edge-clipped detection can hand over a
        # zero-width or -height box, which would make the exemplar crop empty
        target_sz = np.maximum(np.asarray(target_sz, np.float64), 2.0)
        instance_size = self.cfg["instance_size"]
        if self.cfg.get("adaptive"):
            area_ratio = (target_sz[0] * target_sz[1]) / float(im.shape[0] * im.shape[1])
            instance_size = 287 if area_ratio < 0.004 else 271
        score_size = (instance_size - self.EXEMPLAR) // self.STRIDE + 1

        anchors = generate_anchor(self.STRIDE, self.SCALES, self.RATIOS, score_size)
        avg_chans = np.mean(im, axis=(0, 1))

        wc_z = target_sz[0] + self.CONTEXT * target_sz.sum()
        hc_z = target_sz[1] + self.CONTEXT * target_sz.sum()
        s_z = round(np.sqrt(wc_z * hc_z))
        z_crop = get_subwindow(im, target_pos, int(s_z), self.EXEMPLAR, avg_chans)
        with torch.inference_mode():
            kernels = self.model.temple(_crop_tensor(z_crop, self.device))

        hanning = np.hanning(score_size)
        window = np.tile(np.outer(hanning, hanning).flatten(), len(self.RATIOS))
        return SiamState(pos=target_pos, sz=target_sz, kernels=kernels, window=window,
                         anchors=anchors, avg_chans=avg_chans, instance_size=instance_size,
                         im_hw=im.shape[:2])

    def search(self, state: SiamState, im: np.ndarray) -> Tuple[np.ndarray, float]:
        """The search crop of `track` (uint8) and its scale `scale_z`. The
        reference swaps w and h in the search context (`run_SiamRPN.py:
        169-170`); kept for parity."""
        wc_z = state.sz[1] + self.CONTEXT * state.sz.sum()
        hc_z = state.sz[0] + self.CONTEXT * state.sz.sum()
        s_z = np.sqrt(wc_z * hc_z)
        scale_z = self.EXEMPLAR / s_z
        d_search = (state.instance_size - self.EXEMPLAR) / 2
        s_x = s_z + 2 * (d_search / scale_z)
        crop = get_subwindow(im, state.pos, int(round(s_x)), state.instance_size,
                             state.avg_chans)
        return crop, scale_z

    def forward(self, state: SiamState, im: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
        """The network on `track`'s search crop -> (delta (4, N), score (N,))
        as numpy, and the crop's scale."""
        x_crop, scale_z = self.search(state, im)
        with torch.inference_mode():
            delta, score = self.model.track_forward(state.kernels,
                                                    _crop_tensor(x_crop, self.device))
        return delta.cpu().numpy(), score.cpu().numpy(), scale_z

    def track(self, state: SiamState, im: np.ndarray) -> SiamState:
        return self.update(state, *self.forward(state, im))

    def update(self, state: SiamState, delta: np.ndarray, score: np.ndarray,
               scale_z: float) -> SiamState:
        """`tracker_update` of the network's outputs, the position clamped
        to the frame and the size to [10, frame size]."""
        new_pos, new_sz, best_score = tracker_update(
            delta, score, state.anchors, state.window, state.pos, state.sz * scale_z, scale_z,
            self.cfg["penalty_k"], self.cfg["window_influence"], self.cfg["lr"])

        h, w = state.im_hw
        new_pos = np.array([min(max(0, new_pos[0]), w), min(max(0, new_pos[1]), h)])
        new_sz = np.array([min(max(10, new_sz[0]), w), min(max(10, new_sz[1]), h)])
        return replace(state, pos=new_pos, sz=new_sz, score=best_score)


# ---------------------------------------------------------------------------
# Programmed reasoner wiring (reference `programmed_models.py:25-68`)
# ---------------------------------------------------------------------------

class ObjectDetectWithSiamTracker(AbstractReasoner):
    """Snap to the detector's snitch box while it is seen; while it is
    hidden, run the SiamRPN tracker on the pixels from its last position."""

    def __init__(self, tracker: SiamRPNTracker, index_to_track: int = SNITCH_CLASS_INDEX):
        super().__init__(index_to_track)
        self.tracker = tracker
        self.tracker_state: Optional[SiamState] = None
        self.tracker_initiated = False

    def track_for_frame(self, frame, frame_index, frames_predictions,
                        video_name=None) -> None:
        frame_prediction = {
            "bb": frames_predictions["bb"][frame_index],
            "labels": frames_predictions["labels"][frame_index],
        }
        (cx, cy, w, h), (x1, y1, x2, y2) = get_label_bb(frame_prediction, self.index_to_track)

        if cx >= 0 and cy >= 0:
            self.state["target_pos"] = (cx, cy)
            self.state["target_sz"] = (w, h)
            self.state["snitch_box"] = [x1, y1, x2, y2]
            self.tracker_initiated = False
            self.snitch_visible = True
        else:
            self.snitch_visible = False
            if not self.tracker_initiated:
                self.tracker_state = self.tracker.init(
                    frame, np.asarray(self.state["target_pos"], np.float64),
                    np.asarray(self.state["target_sz"], np.float64))
                self.tracker_initiated = True
            self.tracker_state = self.tracker.track(self.tracker_state, frame)
            self.state["target_pos"] = tuple(self.tracker_state.pos)
            self.state["target_sz"] = tuple(self.tracker_state.sz)


def load_siam_model(model_weights: str = "", seed: int = 0) -> SiamRPN:
    """A `SiamRPN` on the CPU from `model_weights`: the upstream torch blob
    (`SiamRPNVOT.model`, a `.pth`/`.model` state_dict), an `.npz` written by
    `utils.checkpoint.save_params`, a `siam_train_main` checkpoint directory
    (its `final.npz`), or empty for seeded weights."""
    model = SiamRPN(torch.Generator().manual_seed(seed))
    if not model_weights:
        return model
    path = Path(model_weights)
    if path.suffix in (".pth", ".model", ".pt"):
        from objectpermanence_tpu_torch.models.convert import siam_state_dict_from_reference
        state = siam_state_dict_from_reference(torch.load(path, map_location="cpu"))
    else:
        from objectpermanence_tpu_torch.utils.checkpoint import load_params
        if path.is_dir() and (path / "final.npz").exists():
            path = path / "final.npz"
        state = load_params(path)
    model.load_state_dict(state)
    print(f"Loaded SiamRPN parameters from {path}")
    return model


def build_siam_reasoner(model_weights: str = "", device=None) -> ObjectDetectWithSiamTracker:
    """The `detector_tracker` reasoner: a tracker of `load_siam_model(
    model_weights)` on `device` (the card unless "cpu")."""
    return ObjectDetectWithSiamTracker(SiamRPNTracker(load_siam_model(model_weights),
                                                      device=device))
