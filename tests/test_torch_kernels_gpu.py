"""The fused OPNet CUDA kernel against its plain version, on the card.

Marked `gpu`; without a CUDA card each test skips (decided inside the
test). On a machine with an H100 and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

(`--noconftest` because `tests/conftest.py` imports JAX, which that
machine does not have.)

Flagship weights, served boxes tiled to B videos of T=300 frames. The
kernel and `opnet_forward_reference` run the same float32 arithmetic with
sums in another order: atol 1e-4 on `y` and the logits, and integer pixel
boxes at most 1 px apart on at most 0.1% of the coordinates.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from objectpermanence_tpu_torch.models.reasoning import OPNet
from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
from objectpermanence_tpu_torch.ops.opnet_fused import (
    opnet_forward_reference, opnet_fused_forward,
)
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
