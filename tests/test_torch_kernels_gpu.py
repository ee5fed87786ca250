"""The port's CUDA kernels against their plain versions, on the card: the
fused OPNet forward (K1), the LSTM recurrence forward, backward and
forward-only kernels (K2, K3, K4), multilevel RoIAlign (K7, and K5/K6, its
one-image entry points) and its backward (K8).

Marked `gpu`; without a CUDA card each test skips (decided inside the
test). On a machine with an H100 and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

(`--noconftest` because `tests/conftest.py` imports JAX, which that
machine does not have.)

Flagship weights, served boxes tiled to B videos of T=300 frames. The
kernel and `opnet_forward_reference` run the same float32 arithmetic with
sums in another order: atol 1e-4 on `y` and the logits, and integer pixel
boxes at most 1 px apart on at most 0.1% of the coordinates. The LSTM
kernels hold `hs`, `cs` and `dxproj` at atol 1e-4 and `dW_hh` at 1e-4 x
max(1, max |reference|), since it sums B x T terms. RoIAlign holds its
output at 1e-4 x max(1, max |reference|): the pyramid's values reach 1e3.
K8 holds each level's gradient at 1e-4 x max(1, max |reference|): it sums
many rois' shares with atomics, in an order that changes from run to run.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from objectpermanence_tpu_torch.models.reasoning import OPNet
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
from objectpermanence_tpu_torch.ops.lstm import lstm_forward
from objectpermanence_tpu_torch.ops.lstm_scan import (
    lstm_scan_backward, lstm_scan_backward_reference, lstm_scan_forward,
    lstm_scan_forward_reference, lstm_scan_hs,
)
from objectpermanence_tpu_torch.ops.opnet_fused import (
    opnet_forward_reference, opnet_fused_forward,
)
from objectpermanence_tpu_torch.train.loop import make_eval_step, make_optimizer, make_train_step
from objectpermanence_tpu_torch.utils.checkpoint import load_params

REPO = Path(__file__).resolve().parent.parent
FLAGSHIP_NPZ = REPO / "objectpermanence_tpu_torch" / "assets" / "opnet_19-08-26_0.514.npz"
BENCH_CACHE = REPO / "bench_data" / "cache" / "ingest_bench50.npz"
FULL = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 256,
        "videos_hidden_dim": 512}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (H100) and nvcc: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(batch, device):
    with np.load(BENCH_CACHE) as blob:
        boxes = blob["boxes"].astype(np.float32)
    reps = -(-batch // boxes.shape[0])
    boxes = np.tile(boxes, (reps, 1, 1, 1))[:batch]
    model = OPNet(FULL)
    model.load_state_dict(load_params(FLAGSHIP_NPZ))
    model = model.to(device).eval()
    weights = [model.att_lstm.w_ih, model.att_lstm.w_hh, model.att_head.w,
               model.video_lstm.w_ih, model.video_lstm.w_hh, model.box_head.w]
    return torch.from_numpy(boxes).to(device), [w.detach() for w in weights], model


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [512, 37, 1])
def test_kernel_matches_plain(batch):
    device = _card()
    boxes, weights, _ = _inputs(batch, device)
    before = opnet_fused_forward.launches
    y, logits = opnet_fused_forward(boxes, *weights)
    torch.cuda.synchronize()
    assert opnet_fused_forward.launches == before + 1
    want_y, want_logits = opnet_forward_reference(boxes, *weights)
    assert y.shape == (batch, 300, 4) and logits.shape == (batch, 15, 300)
    assert torch.isfinite(y).all() and torch.isfinite(logits).all()
    assert (y - want_y).abs().max().item() <= 1e-4
    assert (logits - want_logits).abs().max().item() <= 1e-4
    diff = (denormalize_boxes(y) - denormalize_boxes(want_y)).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.gpu
def test_module_on_cuda_goes_through_kernel():
    device = _card()
    boxes, _, model = _inputs(8, device)
    before = opnet_fused_forward.launches
    with torch.inference_mode():
        y, logits = model(boxes)
    assert opnet_fused_forward.launches == before + 1
    assert y.is_cuda and logits.shape == (8, 15, 300)


def _layer_input(layer, boxes, model):
    """The flagship layer's real input: the scene, or the selected boxes."""
    batch = boxes.shape[0]
    scene = boxes.reshape(batch, 300, -1)
    if layer == "att_lstm":
        return scene, model.att_lstm
    with torch.no_grad():
        h1 = lstm_forward(scene, model.att_lstm.w_ih, model.att_lstm.w_hh)
        probs = torch.softmax(model.att_head(h1), dim=-1)
        return torch.einsum("btof,bto->btf", boxes, probs), model.video_lstm


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [16, 13, 1])
@pytest.mark.parametrize("layer", ["att_lstm", "video_lstm"])
def test_lstm_kernels_match_plain(layer, batch):
    device = _card()
    boxes, _, model = _inputs(batch, device)
    x, lstm = _layer_input(layer, boxes, model)
    w_hh = lstm.w_hh.detach()
    xproj = torch.matmul(x.transpose(0, 1), lstm.w_ih.detach()).contiguous()
    before = (lstm_scan_forward.launches, lstm_scan_backward.launches, lstm_scan_hs.launches)
    hs, cs = lstm_scan_forward(xproj, w_hh)
    hs_only = lstm_scan_hs(xproj, w_hh)
    want_hs, want_cs = lstm_scan_forward_reference(xproj, w_hh)
    h_prev = torch.cat([torch.zeros_like(want_hs[:1]), want_hs[:-1]])
    c_prev = torch.cat([torch.zeros_like(want_cs[:1]), want_cs[:-1]])
    dh_out = torch.randn(want_hs.shape, generator=torch.Generator().manual_seed(batch)).to(device)
    dxproj, d_w_hh = lstm_scan_backward(xproj, h_prev, c_prev, want_cs, dh_out, w_hh)
    torch.cuda.synchronize()
    assert (lstm_scan_forward.launches, lstm_scan_backward.launches,
            lstm_scan_hs.launches) == tuple(n + 1 for n in before)
    want_dxproj, want_d_w_hh = lstm_scan_backward_reference(xproj, h_prev, c_prev, want_cs,
                                                            dh_out, w_hh)
    for got, want in ((hs, want_hs), (cs, want_cs), (hs_only, want_hs), (dxproj, want_dxproj)):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-4
    limit = 1e-4 * max(1.0, want_d_w_hh.abs().max().item())
    assert (d_w_hh - want_d_w_hh).abs().max().item() <= limit


@pytest.mark.gpu
def test_train_step_on_cuda_runs_the_lstm_kernels_not_k1():
    device = _card()
    boxes, _, model = _inputs(16, device)
    model.train()
    labels = torch.rand((16, 300, 4), generator=torch.Generator().manual_seed(0)).to(device)
    mask = torch.zeros((16, 300, 4), dtype=torch.bool, device=device)
    spec = get_model_spec("opnet")
    step = make_train_step(spec, make_optimizer(model.parameters(), 1e-3))
    counts = lambda: (opnet_fused_forward.launches, lstm_scan_forward.launches,  # noqa: E731
                      lstm_scan_backward.launches, lstm_scan_hs.launches)
    before = counts()
    metrics = step(model, boxes, labels, mask, torch.ones(16, device=device))
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    after = counts()
    assert after[0] == before[0]  # never K1
    assert after[1] == before[1] + 2 and after[2] == before[2] + 2  # both LSTMs, both ways
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    make_eval_step(spec)(model, boxes, labels, mask)
    torch.cuda.synchronize()
    assert counts()[3] == after[3] + 2 and counts()[:3] == after[:3]  # eval: K4 only


def _pyramid(batch, n, device, channels=256, seed=0):
    """Random levels of the native 256 x 320 pyramid and rois of every size
    class (sub-pixel, across the edge, up to 600 px), with their levels."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import assign_levels
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.standard_normal((batch, channels, h, w)).astype(np.float32)
                              * 300).to(device)
             for h, w in ((64, 80), (32, 40), (16, 20), (8, 10))]
    xy = rng.uniform(-40, 320, (batch, n, 2))
    wh = np.exp(rng.uniform(np.log(0.3), np.log(600), (batch, n, 2)))
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).to(device)
    return feats, rois, assign_levels(rois)


def _roi_limit(want):
    return 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n", [(30, 300), (7, 123), (1, 1)])
def test_roi_align_batched_matches_plain(batch, n):
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched, roi_align_batched_reference,
    )
    device = _card()
    feats, rois, levels = _pyramid(batch, n, device, seed=n)
    nhwc = [f.contiguous(memory_format=torch.channels_last) for f in feats]
    before = roi_align_batched.launches
    got = roi_align_batched(feats, rois, levels, ROI_STRIDES)
    got_nhwc = roi_align_batched(nhwc, rois, levels, ROI_STRIDES)
    torch.cuda.synchronize()
    assert roi_align_batched.launches == before + 2
    want = roi_align_batched_reference(feats, rois, levels, ROI_STRIDES)
    assert got.shape == (batch, n, 256, 7, 7) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= _roi_limit(want)
    assert torch.equal(got, got_nhwc)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["roi_align_single", "roi_align_tiled"])
@pytest.mark.parametrize("n", [300, 17])
def test_roi_align_one_image_entries_match_plain(entry, n):
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel
    from objectpermanence_tpu_torch.ops.roi_align import multilevel_roi_align
    device = _card()
    feats, rois, levels = _pyramid(1, n, device, seed=n + 1)
    args = ([f[0] for f in feats], rois[0], levels[0], ROI_STRIDES)
    fn = getattr(roi_align_kernel, entry)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = multilevel_roi_align(*args)
    assert got.shape == (n, 256, 7, 7)
    assert (got - want).abs().max().item() <= _roi_limit(want)


@pytest.mark.gpu
def test_detector_on_cuda_goes_through_k7():
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
    from objectpermanence_tpu_torch.ops.roi_align_kernel import roi_align_batched
    _card()
    config = DetectorConfig(min_size=240, max_size=320, rpn_pre_nms_top_n=500,
                            rpn_post_nms_top_n=300)
    detector = CaterDetector(config)
    frames = draw_frames(make_scene(0, num_frames=30))
    before = roi_align_batched.launches
    boxes, labels, scores, valid = detector.detect_video(frames, batch_size=30)
    assert roi_align_batched.launches == before + 1
    assert boxes.shape == (30, 100, 4) and np.isfinite(boxes[valid]).all()


def _backward_case(batch, n, device, seed):
    feats, rois, levels = _pyramid(batch, n, device, seed=seed)
    grad = torch.from_numpy(np.random.RandomState(seed + 1).standard_normal(
        (batch, n, 256, 7, 7)).astype(np.float32)).to(device)
    return feats, rois, levels, grad


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n", [(8, 320), (3, 57), (1, 1)])
def test_roi_align_backward_matches_plain(batch, n):
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched_backward, roi_align_batched_backward_reference,
    )
    device = _card()
    feats, rois, levels, grad = _backward_case(batch, n, device, seed=n + 2)
    shapes = [tuple(f.shape[-2:]) for f in feats]
    before = roi_align_batched_backward.launches
    got = roi_align_batched_backward(grad, rois, levels, shapes, ROI_STRIDES)
    again = roi_align_batched_backward(grad, rois, levels, shapes, ROI_STRIDES)
    torch.cuda.synchronize()
    assert roi_align_batched_backward.launches == before + 2
    want = roi_align_batched_backward_reference(grad, rois, levels, shapes, ROI_STRIDES)
    for g, a, w, f in zip(got, again, want, feats):
        assert g.shape == f.shape and g.is_contiguous() and torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= _roi_limit(w)
        assert (a - w).abs().max().item() <= _roi_limit(w)


@pytest.mark.gpu
def test_roi_align_trainable_launches_k7_forward_and_k8_backward():
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched, roi_align_batched_backward, roi_align_batched_reference,
        roi_align_trainable,
    )
    device = _card()
    feats, rois, levels, grad = _backward_case(2, 40, device, seed=5)
    leaves = [f.clone().requires_grad_(True) for f in feats]
    plain = [f.clone().requires_grad_(True) for f in feats]
    before = (roi_align_batched.launches, roi_align_batched_backward.launches)
    out = roi_align_trainable(leaves, rois, levels, ROI_STRIDES)
    out.backward(grad)
    torch.cuda.synchronize()
    assert (roi_align_batched.launches, roi_align_batched_backward.launches) == (
        before[0] + 1, before[1] + 1)
    want = roi_align_batched_reference(plain, rois, levels, ROI_STRIDES)
    want.backward(grad)
    assert (out - want).abs().max().item() <= _roi_limit(want)
    for got, ref in zip(leaves, plain):
        assert (got.grad - ref.grad).abs().max().item() <= _roi_limit(ref.grad)


@pytest.mark.gpu
def test_detector_train_step_on_cuda_launches_k7_and_k8_once(monkeypatch):
    """One full-width step of the dettrain config (GroupNorm, B=2): K7 in the
    forward and K8 in the backward, once each, and never a plain RoIAlign."""
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    from objectpermanence_tpu_torch.models.detector import anchors as anchor_lib
    from objectpermanence_tpu_torch.models.detector.detector import (
        Detector, DetectorConfig, init_detector,
    )
    from objectpermanence_tpu_torch.models.detector.training import (
        make_detector_train_step, trainable_tensors,
    )
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    from objectpermanence_tpu_torch.train.detector_loop import warmup_schedule
    device = _card()

    def plain(*args, **kwargs):
        raise AssertionError("a plain RoIAlign ran on the card")

    monkeypatch.setattr(rk, "roi_align_batched_reference", plain)
    monkeypatch.setattr(rk, "roi_align_batched_backward_reference", plain)
    config = DetectorConfig(min_size=240, max_size=320, backbone_norm="group",
                            rpn_pre_nms_top_n=500, rpn_post_nms_top_n=300)
    model = init_detector(Detector(config)).to(device)
    tensors = [t for _, t in trainable_tensors(model)]
    optimizer = torch.optim.SGD(tensors, lr=5e-3, momentum=0.9, weight_decay=5e-4)
    anchors = [torch.from_numpy(a).to(device) for a in anchor_lib.pyramid_anchors(
        config.feature_shapes(), config.strides, config.anchor_sizes)]
    step = make_detector_train_step(config, anchors, optimizer, warmup_schedule(5e-3, 10))
    scenes = [make_scene(s, num_frames=20) for s in (0, 1)]
    images = torch.from_numpy(np.stack([draw_frames(s, i)[8] for i, s in enumerate(scenes)]))
    boxes = torch.zeros((2, 20, 4))
    labels = torch.zeros((2, 20), dtype=torch.int64)
    valid = torch.zeros((2, 20), dtype=torch.bool)
    for i, scene in enumerate(scenes):
        vis = np.flatnonzero(scene["visible"][8])
        boxes[i, :len(vis)] = torch.from_numpy(scene["boxes"][8, vis])
        labels[i, :len(vis)] = torch.from_numpy(scene["classes"][vis])
        valid[i, :len(vis)] = True
    before = (rk.roi_align_batched.launches, rk.roi_align_batched_backward.launches)
    parts = step(model, images.float().to(device), boxes.to(device), labels.to(device),
                 valid.to(device), generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    assert (rk.roi_align_batched.launches, rk.roi_align_batched_backward.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(v) for v in parts.values())
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in tensors)
