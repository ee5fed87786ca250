"""The port's CUDA kernels against their plain versions, on the card: the
fused OPNet forward (K1) and the LSTM recurrence forward, backward and
forward-only kernels (K2, K3, K4).

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
max(1, max |reference|), since it sums B x T terms.
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
