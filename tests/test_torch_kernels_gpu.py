"""The port's CUDA kernels against their plain versions, on the card: the
fused OPNet forward (K1), the LSTM recurrence forward, backward and
forward-only kernels (K2, K3, K4), multilevel RoIAlign (K7, and K5/K6, its
one-image entry points), its backward (K8), the windowed RoIAlign (K9) and
the bf16 modes of K1, K7, K8 and K9; the five reasoning models beside OPNet
on the LSTM kernels, transformer_lstm's one-slot encoder against its full
form and its products with the bias and ReLU in the epilogue against the
separate passes, its attention core's kernel against the plain composition
(alone, and in the model's forward), `StackedLSTM`'s launches, `bench_torch.py` and the detector's spans
and blocking reads; the
SiamRPN tracker (library convs, no kernel of the port) on the card against
the CPU.

Marked `gpu`; without a CUDA card each test skips (decided inside the
test). On a machine with an H100 and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

(`--noconftest` because `tests/conftest.py` imports JAX, which that
machine does not have.)

Flagship weights (K1 also at two other widths, seeded), served boxes tiled
to B videos of T=300 frames. The
kernel and `opnet_forward_reference` run the same float32 arithmetic with
sums in another order: atol 1e-4 on `y` and the logits, and integer pixel
boxes at most 1 px apart on at most 0.1% of the coordinates. The LSTM
kernels hold `hs`, `cs` and `dxproj` at atol 1e-4 and `dW_hh` at 1e-4 x
max(1, max |reference|), since it sums B x T terms, up to the eval batch of
400; K2/K4 and K3 also at widths no unit split divides (seeded weights),
two calls of each are bitwise equal, and the forward's plan equals its CPU
mirror. RoIAlign holds its
output at 1e-4 x max(1, max |reference|): the pyramid's values reach 1e3.
K8 holds each level's gradient at 1e-4 x max(1, max |reference|): it sums
many rois' shares in another order than the plain scatter (a fixed one: two
calls are bitwise equal), on ragged B and N, edge rois, every roi on one
level, 320 and 1,100 identical rois, an all-zero dOut, C=96 and 200 and
other pooled sizes; its binning equals the plain binning exactly, and N=0
writes zeros without a launch.
K9 and the bf16 modes (which read the same bf16 values as their plain
versions) are held at the same limit, and K9's count of out-of-contract
rois equals the plain mask's. The RoIAlign forwards also read channels_last
and strided levels in place (bitwise equal to the NCHW call and to a second
call), run at other pooled sizes up to the largest compact tile, and launch
with `launch_plan`'s plan. K1's bf16 mode is held as K1 against its
plain bf16 loop. K8's bf16 mode rounds float32 sums taken in another order
than the plain version's, so its dF is held within one bf16 ulp of max
|reference|.
SiamRPN's `temple` kernels and `track_forward` outputs are held at 1e-4 x
max(1, max |CPU's|) (cuDNN's and the CPU's float32 convs sum in another
order); one train step's gradients at batch 8 with fixed masks are held
against the CPU's float64 gradient: the card's float32 gradient no farther
from it (each tensor's distance over max(1, max |g|)) than twice the CPU's
float32 gradient is, since float32 itself is 1e-2 from it (batch-statistics
batch norm over features with large means cancels); the tracker over a
300-frame fixture video, replayed on the CPU's trajectory, makes each hidden
frame's update on the card within 0.1 px of the CPU's, or, where the two
networks pick different anchors, a pick whose penalized score is within 1e-4
of the CPU's best (a near-tie), with none of the port's kernels launched.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from objectpermanence_tpu_torch.models.reasoning import OPNet
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
from objectpermanence_tpu_torch.ops.lstm import LSTM, StackedLSTM, lstm_forward
from objectpermanence_tpu_torch.ops.lstm_scan import (
    forward_launch_plan, launch_plan, lstm_scan_backward, lstm_scan_backward_reference,
    lstm_scan_forward, lstm_scan_forward_reference, lstm_scan_hs,
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


K1_BATCHES = [512, 37, 1, 16, 1030]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", K1_BATCHES)
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
@pytest.mark.parametrize("batch", K1_BATCHES)
def test_kernel_bf16_matches_plain(batch):
    device = _card()
    boxes, weights, _ = _inputs(batch, device)
    before = opnet_fused_forward.launches
    y, logits = opnet_fused_forward(boxes, *weights, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert opnet_fused_forward.launches == before + 1
    want_y, want_logits = opnet_forward_reference(boxes, *weights, compute_dtype=torch.bfloat16)
    assert y.dtype == logits.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(logits).all()
    assert (y - want_y).abs().max().item() <= 1e-4
    assert (logits - want_logits).abs().max().item() <= 1e-4
    diff = (denormalize_boxes(y) - denormalize_boxes(want_y)).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


def _seeded_weights(att_hidden, vid_hidden, device, objects=15, feat=6, seed=0):
    """OPNet weights at other widths, uniform in +-1/sqrt(fan-in) as
    PyTorch's LSTM initialises them."""
    rng = np.random.RandomState(seed)
    shapes = [(objects * feat, 4 * att_hidden), (att_hidden, 4 * att_hidden),
              (att_hidden, objects), (feat, 4 * vid_hidden), (vid_hidden, 4 * vid_hidden),
              (vid_hidden, 4)]
    bounds = [att_hidden, att_hidden, att_hidden, vid_hidden, vid_hidden, vid_hidden]
    return [torch.from_numpy((rng.uniform(-1, 1, shape) / np.sqrt(n)).astype(np.float32))
            .to(device) for shape, n in zip(shapes, bounds)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths", [(16, 24), (132, 260)])
@pytest.mark.parametrize("batch", K1_BATCHES)
def test_kernel_other_widths_match_plain(batch, widths, dtype):
    """K1 at a narrow width and at one (132/260) that no slice count divides,
    seeded weights, both operand modes."""
    device = _card()
    compute_dtype = getattr(torch, dtype)
    boxes, _, _ = _inputs(batch, device)
    weights = _seeded_weights(*widths, device)
    y, logits = opnet_fused_forward(boxes, *weights, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    want_y, want_logits = opnet_forward_reference(boxes, *weights, compute_dtype=compute_dtype)
    assert torch.isfinite(y).all() and torch.isfinite(logits).all()
    assert (y - want_y).abs().max().item() <= 1e-4
    assert (logits - want_logits).abs().max().item() <= 1e-4
    diff = (denormalize_boxes(y) - denormalize_boxes(want_y)).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [16, 512])
def test_opnet_plan(batch, dtype):
    from objectpermanence_tpu_torch.ops.opnet_fused import launch_plan
    _card()
    props = torch.cuda.get_device_properties(0)
    plan = launch_plan(batch, 256, 512, getattr(torch, dtype))
    assert plan["groups"] * plan["slices"] == plan["blocks"] <= props.multi_processor_count
    assert plan["smem"] <= props.shared_memory_per_block_optin
    assert 1 <= plan["groups"] <= batch and plan["scratch"] > 0


@pytest.mark.gpu
def test_predict_step_bf16_on_cuda_goes_through_kernel():
    from objectpermanence_tpu_torch.infer.reasoning import make_predict_step
    device = _card()
    boxes, weights, model = _inputs(8, device)
    before = opnet_fused_forward.launches
    got = make_predict_step(get_model_spec("opnet"), compute_dtype=torch.bfloat16)(model, boxes)
    assert opnet_fused_forward.launches == before + 1
    want_y, _ = opnet_forward_reference(boxes, *weights, compute_dtype=torch.bfloat16)
    diff = (got - denormalize_boxes(want_y)).abs()
    assert got.shape == (8, 300, 4) and diff.max().item() <= 1


@pytest.mark.gpu
def test_predict_step_spans_on_cuda():
    """Under `trace.recording()`: OPNet's `predict_step` at B=16 makes one
    blocking copy a call, `denormalize_boxes`' scale, inside its root's
    host interval; transformer_lstm's encoder has a device interval that is
    positive and under its call's host interval."""
    from objectpermanence_tpu_torch.config import load_model_config
    from objectpermanence_tpu_torch.infer.reasoning import make_predict_step
    from objectpermanence_tpu_torch.utils import trace
    device = _card()
    boxes, _, opnet = _inputs(16, device)
    config = load_model_config("transformer_lstm")
    spec = get_model_spec("transformer_lstm", config)
    transformer = spec.build(config, torch.Generator().manual_seed(3)).to(device).eval()
    for name, model, x in (("opnet", opnet, boxes),
                           ("transformer_lstm", transformer,
                            boxes[..., :spec.feature_width].contiguous())):
        predict = make_predict_step(get_model_spec(name), device=device, out_dtype=torch.int16)
        predict(model, x)
        trace.clear()
        with trace.recording():
            for _ in range(3):
                predict(model, x)
        torch.cuda.synchronize()
        kept = trace.spans()
        trace.clear()
        roots = [s for s in kept if s.parent is None]
        assert [s.name for s in roots] == ["objperm.serve.predict"] * 3
        for root in roots:
            mine = {s.name: s for s in kept if s.root == root.id and s is not root}
            assert root.syncs == 1 and root.device_ms is None and root.host_ms > 0
            copy = mine["objperm.host.h2d"]
            assert root.start_ns <= copy.start_ns <= copy.end_ns <= root.end_ns
            if name == "transformer_lstm":
                assert 0 < mine["objperm.model.encoder"].device_ms < root.host_ms


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
@pytest.mark.parametrize("batch", [16, 13, 1, 37, 64, 400])
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


def _lstm_forward_case(hidden, batch, device, seed, in_dim=6, frames=300):
    """Seeded xproj (T, B, 4H) and w_hh (H, 4H) of one LSTM layer."""
    rng = np.random.default_rng(seed)
    w_ih = torch.from_numpy((rng.standard_normal((in_dim, 4 * hidden)) * 0.3).astype(np.float32))
    w_hh = torch.from_numpy((rng.standard_normal((hidden, 4 * hidden))
                             / np.sqrt(hidden)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((frames, batch, in_dim)).astype(np.float32))
    return torch.matmul(x.to(device), w_ih.to(device)).contiguous(), w_hh.to(device)


FORWARD_WIDTHS = [16, 24, 132, 256, 260, 512, 1024]
FORWARD_BATCHES = [1, 13, 16, 37, 64, 400, 512]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 13, 37, 400])
@pytest.mark.parametrize("hidden", [16, 24, 132, 260, 1024])
def test_lstm_forward_other_widths_match_plain(hidden, batch):
    """K2 and K4 at widths and batches no unit or video split divides evenly
    (seeded weights), one launch each."""
    device = _card()
    xproj, w_hh = _lstm_forward_case(hidden, batch, device, seed=hidden + batch)
    before = (lstm_scan_forward.launches, lstm_scan_hs.launches)
    hs, cs = lstm_scan_forward(xproj, w_hh)
    hs_only = lstm_scan_hs(xproj, w_hh)
    torch.cuda.synchronize()
    assert (lstm_scan_forward.launches, lstm_scan_hs.launches) == (before[0] + 1, before[1] + 1)
    want_hs, want_cs = lstm_scan_forward_reference(xproj, w_hh)
    for got, want in ((hs, want_hs), (cs, want_cs), (hs_only, want_hs)):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,batch", [(512, 16), (256, 13), (512, 400), (256, 400),
                                          (132, 37)])
def test_lstm_forward_is_deterministic(hidden, batch):
    """Two calls of K2 and of K4 give bitwise-equal outputs, and K4's hs is
    K2's: every sum is taken in a fixed order, with no atomics on data."""
    device = _card()
    xproj, w_hh = _lstm_forward_case(hidden, batch, device, seed=11)
    first, second = lstm_scan_forward(xproj, w_hh), lstm_scan_forward(xproj, w_hh)
    hs_a, hs_b = lstm_scan_hs(xproj, w_hh), lstm_scan_hs(xproj, w_hh)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(hs_a, hs_b) and torch.equal(hs_a, first[0])


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", FORWARD_WIDTHS)
def test_lstm_forward_plan_is_the_mirror_and_fits_the_card(hidden):
    """The library's forward plan (`make_fwd_plan`) equals its CPU mirror
    `forward_launch_plan` at this card's SMs and shared memory, and fits."""
    _card()
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    smem_max = props.shared_memory_per_block_optin
    for batch in FORWARD_BATCHES:
        plan = launch_plan(hidden, batch=batch)
        assert plan == forward_launch_plan(hidden, batch, sms, smem_max), (hidden, batch)
        assert 1 <= plan["blocks"] == plan["groups"] * plan["slices"] <= sms
        assert plan["slices"] * plan["units"] >= hidden > (plan["slices"] - 1) * plan["units"]
        assert plan["smem"] <= smem_max
        assert plan["passes"] * plan["groups"] * plan["videos"] >= batch


def _lstm_backward_case(hidden, batch, device, seed, in_dim=6, frames=300):
    """Seeded weights and inputs of one LSTM layer at `hidden` units, and the
    forward's residuals from the plain loop."""
    rng = np.random.default_rng(seed)
    w_ih = torch.from_numpy((rng.standard_normal((in_dim, 4 * hidden)) * 0.3).astype(np.float32))
    w_hh = torch.from_numpy((rng.standard_normal((hidden, 4 * hidden))
                             / np.sqrt(hidden)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((frames, batch, in_dim)).astype(np.float32))
    dh_out = torch.from_numpy(rng.standard_normal((frames, batch, hidden)).astype(np.float32))
    xproj = torch.matmul(x.to(device), w_ih.to(device)).contiguous()
    w_hh = w_hh.to(device)
    hs, cs = lstm_scan_forward_reference(xproj, w_hh)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
    return xproj, h_prev, c_prev, cs, dh_out.to(device), w_hh


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 16, 37])
@pytest.mark.parametrize("hidden", [24, 132, 260])
def test_lstm_backward_other_widths_match_plain(hidden, batch):
    """K3 at widths where no unit split divides the units evenly."""
    device = _card()
    args = _lstm_backward_case(hidden, batch, device, seed=hidden + batch)
    before = lstm_scan_backward.launches
    dxproj, d_w_hh = lstm_scan_backward(*args)
    torch.cuda.synchronize()
    assert lstm_scan_backward.launches == before + 1
    want_dxproj, want_d_w_hh = lstm_scan_backward_reference(*args)
    assert torch.isfinite(dxproj).all() and torch.isfinite(d_w_hh).all()
    assert (dxproj - want_dxproj).abs().max().item() <= 1e-4
    limit = 1e-4 * max(1.0, want_d_w_hh.abs().max().item())
    assert (d_w_hh - want_d_w_hh).abs().max().item() <= limit


@pytest.mark.gpu
@pytest.mark.parametrize("hidden,batch", [(512, 16), (256, 13), (132, 37)])
def test_lstm_backward_is_deterministic(hidden, batch):
    """Two calls give bitwise-equal dxproj and dW_hh: every sum is taken in
    a fixed order, with no atomics on data."""
    device = _card()
    args = _lstm_backward_case(hidden, batch, device, seed=7)
    first = lstm_scan_backward(*args)
    second = lstm_scan_backward(*args)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
@pytest.mark.parametrize("hidden", [16, 132, 256, 260, 512])
def test_lstm_backward_plan_fits_the_card(hidden):
    _card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = launch_plan(hidden, backward=True)
    assert 1 <= plan["blocks"] == plan["groups"] * plan["slices"] <= sms
    assert plan["slices"] * plan["units"] >= hidden > (plan["slices"] - 1) * plan["units"]
    assert plan["groups"] <= 16 and 1 <= plan["stage"] and plan["smem"] <= 232448
    assert plan["scratch"] >= 4 * plan["groups"]


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


NEW_MODELS = [("baseline_lstm", False), ("non_linear_lstm", False), ("transformer_lstm", False),
              ("transformer_lstm", True), ("opnet_lstm_mlp", False), ("opnet_moe", False)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,compat", NEW_MODELS,
                         ids=[n + ("_reference_compat" if c else "") for n, c in NEW_MODELS])
def test_new_model_on_card_matches_cpu(name, compat):
    """The five other architectures at their shipped widths on 4 served
    videos (2 with reference_compat): `forward_layers` on K4 against the
    CPU's plain loop within 1e-4, and one train step's gradients on K2/K3
    within 1e-4 x max(1, max |cpu's|), in eval mode (no dropout); K1 never."""
    import copy
    from objectpermanence_tpu_torch.config import load_model_config
    device = _card()
    batch = 2 if compat else 4
    config = {**load_model_config(name), **({"reference_compat": True} if compat else {})}
    spec = get_model_spec(name, config)
    cpu = spec.build(config, torch.Generator().manual_seed(3)).eval()
    gpu = copy.deepcopy(cpu).to(device)
    boxes, _, _ = _inputs(batch, device)
    boxes = boxes[:, :300, :, :spec.feature_width].contiguous()
    counts = lambda: (opnet_fused_forward.launches, lstm_scan_forward.launches,  # noqa: E731
                      lstm_scan_backward.launches, lstm_scan_hs.launches)
    layers = sum(isinstance(m, LSTM) for m in cpu.modules())
    before = counts()
    with torch.no_grad():
        got = gpu.forward_layers(boxes)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2], before[3] + layers)
    with torch.no_grad():
        want = cpu.forward_layers(boxes.cpu())
    for g, w in zip(*((got, want) if spec.double_output else ((got,), (want,)))):
        assert (g.cpu() - w).abs().max().item() <= 1e-4
    labels = torch.rand((batch, 300, 4), generator=torch.Generator().manual_seed(1))
    mask = torch.zeros((batch, 300, 4), dtype=torch.bool)
    grads = []
    for model, dev in ((gpu, device), (cpu, torch.device("cpu"))):
        before = counts()
        make_train_step(spec, make_optimizer(model.parameters(), 1e-3))(
            model, boxes.to(dev), labels.to(dev), mask.to(dev), torch.ones(batch, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert counts() == (before[0], before[1] + layers, before[2] + layers, before[3])
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    for key, want_grad in grads[1].items():
        limit = 1e-4 * max(1.0, want_grad.abs().max().item())
        assert (grads[0][key] - want_grad).abs().max().item() <= limit, key


def _transformer_full_rows(model, boxes, generator=None):
    """`TransformerLSTM.forward_layers` with the encoder's full form, slot 0
    taken after it."""
    batch, frames, objects = boxes.shape[:3]
    feats = torch.relu(model.box_proj(boxes)).reshape(batch * frames, objects, -1)
    snitch = model.encoder(feats, generator)[:, 0]
    return model.box_head(model.video_lstm(snitch.reshape(batch, frames, -1)))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["eval", "train_step"])
def test_transformer_one_slot_encoder_matches_full_rows(mode):
    """transformer_lstm at its shipped widths on 16 served videos (a train
    batch), TF32 off: `forward_layers` (the encoder's last layer on slot 0's
    rows) against the full form's slot 0 within 1e-6 x max |full's|, in eval
    mode on K4 and in one train step on K2/K3 with dropout from one seeded
    generator, whose state both forms leave the same; the step's gradients,
    which sum over fewer rows, within 1e-5 x max(1, max |full's|) a leaf."""
    from objectpermanence_tpu_torch.config import load_model_config
    device = _card()
    config = load_model_config("transformer_lstm")
    model = get_model_spec("transformer_lstm", config).build(
        config, torch.Generator().manual_seed(3)).to(device)
    boxes, _, _ = _inputs(16, device)
    boxes = boxes[..., :5].contiguous()
    if mode == "eval":
        with torch.no_grad():
            got = model.eval().forward_layers(boxes)
            want = _transformer_full_rows(model, boxes)
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
        return
    model.train()
    outs, states, grads = [], [], []
    for forward in (model.forward_layers, functools.partial(_transformer_full_rows, model)):
        generator = torch.Generator(device).manual_seed(11)
        model.zero_grad()
        y = forward(boxes, generator)
        y.square().mean().backward()
        outs.append(y.detach())
        states.append(generator.get_state())
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    torch.cuda.synchronize()
    assert torch.equal(states[0], states[1])
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6 * outs[1].abs().max().item()
    for key, want_grad in grads[1].items():
        limit = 1e-5 * max(1.0, want_grad.abs().max().item())
        assert (grads[0][key] - want_grad).abs().max().item() <= limit, key


def _composed(x, w, b, relu=False):
    """The products as they ran before their epilogues took the bias:
    `matmul`, then `+ b`, then the ReLU."""
    y = torch.matmul(x, w) + b
    return torch.relu(y) if relu else y


@pytest.mark.gpu
def test_transformer_encoder_runs_bias_and_relu_in_the_products(monkeypatch):
    """transformer_lstm at its shipped widths on 8 served videos, eval, TF32
    off: `forward_layers` with each biased product's bias (and ff1's ReLU)
    in its epilogue against the `matmul` + `b` (+ `relu`) composition within
    1e-5 x max |composition's|; `linear_bias.launches` reads 8 a forward (QKV,
    out, ff1, ff2 in each of 2 layers); the encoder, profiled, launches no
    ReLU kernel and no add kernels but its 4 residual adds."""
    from torch.profiler import ProfilerActivity, profile

    from objectpermanence_tpu_torch.config import load_model_config
    from objectpermanence_tpu_torch.ops import attention, linear
    device = _card()
    config = load_model_config("transformer_lstm")
    model = get_model_spec("transformer_lstm", config).build(
        config, torch.Generator().manual_seed(3))
    draw = torch.Generator().manual_seed(4)
    with torch.no_grad():  # biases away from their zero inits
        for name, param in model.named_parameters():
            if name.endswith((".b", "b_in")):
                param.uniform_(-0.5, 0.5, generator=draw)
    model = model.to(device).eval()
    boxes, _, _ = _inputs(8, device)
    boxes = boxes[..., :5].contiguous()
    with torch.no_grad():
        before = linear.linear_bias.launches
        got = model.forward_layers(boxes)
        assert linear.linear_bias.launches - before == 8
        with monkeypatch.context() as patch:
            patch.setattr(attention, "linear_bias", _composed)
            patch.setattr(linear, "linear_bias", _composed)
            want = model.forward_layers(boxes)
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
        feats = torch.relu(model.box_proj(boxes)).reshape(8 * 300, 15, -1)
        model.encoder(feats, slot=0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.encoder(feats, slot=0)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    assert sum("gemm" in n.lower() for n in names) >= 8, names
    elementwise = [n for n in names if "gemm" not in n.lower()]
    assert not [n for n in elementwise if "clamp" in n or "relu" in n.lower()], elementwise
    assert sum("CUDAFunctor_add" in n for n in elementwise) == 4, elementwise


def _encoder_qkv(frames, device):
    """transformer_lstm at its shipped widths (seeded): its first encoder
    layer's QKV product over the served boxes' first `frames` frames,
    `(frames, 15, 768)`, and the head count."""
    from objectpermanence_tpu_torch.config import load_model_config
    from objectpermanence_tpu_torch.ops.linear import linear_bias
    config = load_model_config("transformer_lstm")
    model = get_model_spec("transformer_lstm", config).build(
        config, torch.Generator().manual_seed(3)).to(device).eval()
    videos = -(-frames // 300)
    boxes, _, _ = _inputs(videos, device)
    attn = model.encoder[0].attn
    with torch.no_grad():
        feats = torch.relu(model.box_proj(boxes[..., :5].contiguous()))
        feats = feats.reshape(videos * 300, 15, -1)[:frames]
        dim = feats.shape[-1]
        qkv = linear_bias(feats, attn.w_in.reshape(dim, 3 * dim), attn.b_in.reshape(3 * dim))
    return qkv, attn.w_in.shape[2]


@pytest.mark.gpu
@pytest.mark.parametrize("frames,strided", [(1, False), (37, False), (4800, False), (37, True)],
                         ids=["n1", "n37", "n4800", "n37_strided"])
def test_attention_core_kernel_matches_plain(frames, strided):
    """`csrc/attention_core.cu` against the plain composition at the shipped
    widths (D 256, 2 heads, L 15), TF32 off, on one frame, fewer frames than
    the persistent grid has blocks, and 4,800 (the grid's last round ragged),
    also on every other sequence of a larger product (strides read in
    place): ctx within 2e-6 x max |plain| (fp32 sums over 128 and 15 terms
    in another order than cuBLAS's), one launch a call; the one-slot form
    for slots 0, 7 and 14 equal bit for bit to the full form's row."""
    from objectpermanence_tpu_torch.ops.attention_core import (
        attention_core, attention_core_reference,
    )
    device = _card()
    qkv, heads = _encoder_qkv(2 * frames if strided else frames, device)
    if strided:
        qkv = qkv[::2]
    with torch.no_grad():
        before = attention_core.launches
        got = attention_core(qkv, heads)
        torch.cuda.synchronize()
        assert attention_core.launches == before + 1
        want = attention_core_reference(qkv, heads)
        assert got.shape == want.shape == (frames, 15, 256) and got.is_contiguous()
        assert (got - want).abs().max().item() <= 2e-6 * want.abs().max().item()
        for slot in (0, 7, 14):
            row = attention_core(qkv, heads, slot)
            assert row.shape == (frames, 256)
            assert torch.equal(row, got[:, slot])
    assert attention_core.launches == before + 4


# (length, heads, head_dim) reaching each of the kernel's instantiations,
# <LMAX, F> with LMAX 16 for length <= 16 else 32 and F the float4s a lane
# holds, ceil(head_dim / 32) rounded up to 1, 2, 4 or 8; head_dims that are
# not a multiple of 32 leave lanes of a group idle, and D 2,048 stages rows of
# more float4s than a block has threads
ATTENTION_CORE_SHAPES = [(1, 3, 4), (15, 3, 12), (16, 4, 32), (15, 1, 36), (16, 2, 64),
                         (16, 1, 100), (16, 2, 256), (2, 8, 256), (17, 8, 32), (32, 1, 4),
                         (32, 2, 64), (32, 2, 128), (17, 1, 252), (32, 1, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("length,heads,head_dim", ATTENTION_CORE_SHAPES,
                         ids=[f"l{l}_h{h}_d{d}" for l, h, d in ATTENTION_CORE_SHAPES])
def test_attention_core_kernel_every_instantiation(length, heads, head_dim):
    """Each <LMAX, F> that the dispatch rule admits, on 600 sequences (more
    than the persistent grid's blocks) of a seeded N(0, 1) QKV product, TF32
    off: one launch a call; ctx no further from the float64 composition than
    twice the plain float32 composition is, plus half an ulp of its largest
    output (both sum in float32, in other orders: at head_dim 256 the plain
    one is itself about 1.2e-6 x max off); the one-slot form for the first
    and the last slot equal bit for bit to the full form's row."""
    from objectpermanence_tpu_torch.ops.attention_core import (
        attention_core, attention_core_reference, kernel_takes,
    )
    device = _card()
    dim = heads * head_dim
    qkv = torch.randn((600, length, 3 * dim),
                      generator=torch.Generator().manual_seed(length * 1000 + head_dim)).to(device)
    with torch.no_grad():
        assert kernel_takes(qkv, heads)
        before = attention_core.launches
        got = attention_core(qkv, heads)
        torch.cuda.synchronize()
        assert attention_core.launches == before + 1
        exact = attention_core_reference(qkv.double(), heads)
        plain = attention_core_reference(qkv, heads)
        assert got.shape == plain.shape == (600, length, dim)
        err = (got.double() - exact).abs().max().item()
        plain_err = (plain.double() - exact).abs().max().item()
        assert err <= 2 * plain_err + 2 ** -24 * exact.abs().max().item(), (err, plain_err)
        for slot in sorted({0, length - 1}):
            assert torch.equal(attention_core(qkv, heads, slot), got[:, slot])


def _kernel_kind(name):
    for kind in ("gemm", "attention_core_kernel", "layer_norm", "CUDAFunctor_add"):
        if kind in name:
            return kind
    return name


@pytest.mark.gpu
def test_transformer_attention_core_kernel_in_the_model(monkeypatch):
    """transformer_lstm at its shipped widths on 8 served videos, TF32 off:
    the eval `forward_layers` on the kernel against the plain core within
    1e-5 x max |plain's|; `attention_core.launches` reads 2 an eval forward
    and 0 a train step; the encoder, profiled, launches its 8 products, the
    2 attention cores, 4 LayerNorms and 4 residual adds and no other kernel
    (a memset of the products' workspace is no kernel): no copy, no batched
    product, no scale or softmax pass."""
    from torch.profiler import ProfilerActivity, profile

    from objectpermanence_tpu_torch.config import load_model_config
    from objectpermanence_tpu_torch.ops import attention
    from objectpermanence_tpu_torch.ops.attention_core import (
        attention_core, attention_core_reference,
    )
    device = _card()
    config = load_model_config("transformer_lstm")
    spec = get_model_spec("transformer_lstm", config)
    model = spec.build(config, torch.Generator().manual_seed(3)).to(device).eval()
    boxes, _, _ = _inputs(8, device)
    boxes = boxes[..., :5].contiguous()
    with torch.no_grad():
        before = attention_core.launches
        got = model.forward_layers(boxes)
        torch.cuda.synchronize()
        assert attention_core.launches - before == 2
        with monkeypatch.context() as patch:
            patch.setattr(attention, "attention_core", attention_core_reference)
            want = model.forward_layers(boxes)
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
        feats = torch.relu(model.box_proj(boxes)).reshape(8 * 300, 15, -1)
        model.encoder(feats, slot=0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.encoder(feats, slot=0)
            torch.cuda.synchronize()
    kinds = {}
    for event in prof.events():
        if event.device_type.name == "CUDA" and not event.name.startswith("Memset"):
            kind = _kernel_kind(event.name)
            kinds[kind] = kinds.get(kind, 0) + 1
    assert kinds == {"gemm": 8, "attention_core_kernel": 2, "layer_norm": 4,
                     "CUDAFunctor_add": 4}, kinds
    labels = torch.rand((8, 300, 4), generator=torch.Generator().manual_seed(1)).to(device)
    mask = torch.zeros((8, 300, 4), dtype=torch.bool, device=device)
    before = attention_core.launches
    make_train_step(spec, make_optimizer(model.train().parameters(), 1e-3))(
        model, boxes, labels, mask, torch.ones(8, device=device))
    torch.cuda.synchronize()
    assert attention_core.launches == before


@pytest.mark.gpu
def test_stacked_lstm_launch_counts():
    """A 3-layer StackedLSTM: K2 and K3 once per layer with a gradient, K4
    once per layer without; its output equals the layers run one by one."""
    device = _card()
    stack = StackedLSTM(90, 512, 3, torch.Generator().manual_seed(4)).to(device)
    boxes, _, _ = _inputs(16, device)
    x = boxes[:, :300].reshape(16, 300, 90).contiguous()
    counts = lambda: (lstm_scan_forward.launches, lstm_scan_backward.launches,  # noqa: E731
                      lstm_scan_hs.launches)
    before = counts()
    with torch.no_grad():
        h = stack(x)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 3)
    out = stack(x)
    out.sum().backward()
    torch.cuda.synchronize()
    assert counts() == (before[0] + 3, before[1] + 3, before[2] + 3)
    torch.testing.assert_close(out.detach(), h, rtol=0, atol=0)
    with torch.no_grad():
        layer_by_layer = stack[2](stack[1](stack[0](x)))
    assert torch.equal(layer_by_layer, h)


@pytest.mark.gpu
def test_bench_torch_on_card():
    import json
    import subprocess
    import sys
    _card()
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch.py"), "--batch", "64"],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert list(result) == ["metric", "value", "unit", "vs_baseline", "compute_fps",
                            "compute_fps_bf16", "link_efficiency", "data"]
    assert result["value"] > 0 and result["compute_fps"] > 0 and result["compute_fps_bf16"] > 0


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


@pytest.mark.gpu
def test_detect_video_spans_and_syncs_on_cuda():
    """Under `trace.recording()`, a video of 2 chunks at the shipped
    preprocess geometry: the root `objperm.detect.video`, each chunk's three
    device spans with positive device intervals, the NMS kernel twice a
    chunk (the RPN's and the class NMS), and a `host_syncs` delta of the
    video's copies alone (its frames in once; boxes, labels, scores, valid
    out once): NMS waits for nothing on the card, nor does a chunk wait for
    the one before. The outputs are `__call__`'s chunk by chunk."""
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
    from objectpermanence_tpu_torch.ops import nms
    from objectpermanence_tpu_torch.utils import trace
    _card()
    config = DetectorConfig(min_size=240, max_size=320, rpn_pre_nms_top_n=500,
                            rpn_post_nms_top_n=300)
    detector = CaterDetector(config)
    frames = draw_frames(make_scene(2, num_frames=16))
    detector.detect_video(frames, batch_size=8)
    trace.clear()
    before, launches = trace.host_syncs, nms.nms_mask.launches
    with trace.recording():
        detector.detect_video(frames, batch_size=8)
    torch.cuda.synchronize()
    kept = trace.spans()
    trace.clear()
    roots = [s for s in kept if s.parent is None]
    assert [s.name for s in roots] == ["objperm.detect.video"]
    root = roots[0]
    for name in ("backbone", "proposals", "heads"):
        spans = [s for s in kept if s.name == f"objperm.detector.{name}"]
        assert len(spans) == 2 and all(s.parent == root.id and s.device_ms > 0 for s in spans)
    assert nms.nms_mask.launches - launches == 2 * 2
    assert root.syncs == trace.host_syncs - before == 1 + 4
    whole = detector.detect_video(frames, batch_size=8)
    chunked = [detector(frames[start:start + 8]) for start in (0, 8)]
    for got, parts in zip(whole, zip(*chunked)):
        np.testing.assert_array_equal(got, np.concatenate(parts))


def _nms_rows(rng, rows, n, spread=60.0):
    """Clustered boxes (rows, n, 4), scores with ties (a tenth repeat a
    neighbour) and a sixth padding (NEG_INF)."""
    from objectpermanence_tpu_torch.ops.nms import NEG_INF
    centre = rng.uniform(0, 320, (rows, 1 + n // 20, 2))[:, rng.randint(0, 1 + n // 20, n)]
    centre = centre + rng.normal(0, 4, (rows, n, 2))
    size = rng.uniform(4, spread, (rows, n, 2))
    boxes = np.concatenate([centre - size / 2, centre + size / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (rows, n)).astype(np.float32)
    tied = rng.uniform(size=(rows, n)) < 0.1
    scores[:, 1:][tied[:, 1:]] = scores[:, :-1][tied[:, 1:]]
    scores[rng.uniform(size=(rows, n)) < 1 / 6] = NEG_INF
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,threshold", [(3, 1, 0.5), (5, 63, 0.7), (4, 64, 0.5),
                                              (6, 65, 0.7), (150, 500, 0.7), (30, 1000, 0.5),
                                              (2, 2000, 0.5), (1, 4500, 0.3)])
def test_nms_kernel_is_the_plain_fixed_point(rows, n, threshold):
    """`csrc/nms.cu` against the plain rounds on the CPU, mask for mask: rows
    on both sides of a 64-box word, the RPN's 150 x 500 and the class NMS's
    30 x 1000 of a chunk, and rows longer than one block's walk. Its IoU is
    the plain one rounding for rounding, so the masks are equal bit for
    bit; one launch a call."""
    from objectpermanence_tpu_torch.ops import nms
    _card()
    boxes, scores = _nms_rows(np.random.RandomState(n), rows, n)
    want = nms.nms_mask(boxes, scores, threshold)
    before = nms.nms_mask.launches
    got = nms.nms_mask(boxes.cuda(), scores.cuda(), threshold)
    torch.cuda.synchronize()
    assert nms.nms_mask.launches == before + 1
    assert torch.equal(got.cpu(), want)
    valid = int((scores > nms.NEG_INF / 10).sum())
    assert 0 < int(want.sum()) < valid or n == 1


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
        assert torch.equal(g, a)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,n", [(4, 320), (3, 57), (1, 1)])
def test_roi_align_backward_bf16_matches_plain(batch, n):
    """dF in bf16 at the 800 px pyramid: the float32 mode's sums within
    1e-4 x max(1, max |reference|), the bf16 dF within one bf16 ulp of
    max |reference|."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched_backward, roi_align_batched_backward_reference,
    )
    device = _card()
    feats, rois, levels = _pyramid_800(batch, n, device, torch.bfloat16, seed=n + 3)
    grad = torch.from_numpy(np.random.RandomState(n).standard_normal(
        (batch, n, 256, 7, 7)).astype(np.float32)).to(device)
    shapes = [tuple(f.shape[-2:]) for f in feats]
    before = roi_align_batched_backward.launches
    got = roi_align_batched_backward(grad, rois, levels, shapes, ROI_STRIDES, dtype=torch.bfloat16)
    sums = roi_align_batched_backward(grad, rois, levels, shapes, ROI_STRIDES)
    torch.cuda.synchronize()
    assert roi_align_batched_backward.launches == before + 2
    want = roi_align_batched_backward_reference(grad, rois, levels, shapes, ROI_STRIDES)
    for g, s, w, f in zip(got, sums, want, feats):
        assert g.dtype == torch.bfloat16 and g.shape == f.shape and g.is_contiguous()
        assert (s - w).abs().max().item() <= _roi_limit(w)
        scale = w.abs().max().item()
        assert scale == 0 or (g.float() - w.to(torch.bfloat16).float()).abs().max().item() <= \
            _bf16_ulp(scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_windowed_trainable_launches_k9_forward_and_k8_backward(dtype):
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched_backward, roi_align_batched_backward_reference, roi_align_windowed,
        roi_align_windowed_reference, roi_align_windowed_trainable,
    )
    device = _card()
    feats, rois, levels = _pyramid_800(2, 40, device, getattr(torch, dtype), seed=6)
    grad = torch.from_numpy(np.random.RandomState(6).standard_normal(
        (2, 40, 256, 7, 7)).astype(np.float32)).to(device)
    leaves = [f.clone().requires_grad_(True) for f in feats]
    before = (roi_align_windowed.launches, roi_align_batched_backward.launches)
    out = roi_align_windowed_trainable(leaves, rois, levels, ROI_STRIDES)
    out.backward(grad)
    torch.cuda.synchronize()
    window_lib.reset_contract_stats()
    assert (roi_align_windowed.launches, roi_align_batched_backward.launches) == (
        before[0] + 1, before[1] + 1)
    want = roi_align_windowed_reference(feats, rois, levels, ROI_STRIDES)
    assert (out - want).abs().max().item() <= _roi_limit(want)
    shapes = [tuple(f.shape[-2:]) for f in feats]
    want_grads = roi_align_batched_backward_reference(grad, rois, levels, shapes, ROI_STRIDES)
    for leaf, w in zip(leaves, want_grads):
        assert leaf.grad.dtype == leaf.dtype
        limit = _roi_limit(w) if dtype == "float32" else _bf16_ulp(max(w.abs().max().item(), 1e-30))
        assert (leaf.grad.float() - w.to(leaf.dtype).float()).abs().max().item() <= limit


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


def _pyramid_800(batch, n, device, dtype, seed=0):
    """Random levels of the 800 px pyramid (P2-P5 of 200 x 272 to 25 x 34)
    in `dtype`, and rois of every size class, a few of them 600 x 8 px:
    out of the windowed kernel's contract."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import assign_levels
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.standard_normal((batch, 256, h, w)).astype(np.float32)
                              * 100).to(device=device, dtype=dtype)
             for h, w in ((200, 272), (100, 136), (50, 68), (25, 34))]
    xy = rng.uniform(-40, 1088, (batch, n, 2))
    wh = np.exp(rng.uniform(np.log(0.3), np.log(900), (batch, n, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[0, :min(n, 4)] = [[100, 200, 700, 208], [50, 100, 58, 700],
                           [300, 500, 900, 508], [1000, 10, 1008, 610]][:min(n, 4)]
    rois = torch.from_numpy(rois).to(device)
    return feats, rois, assign_levels(rois)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,n", [(8, 300), (3, 57), (1, 1)])
def test_roi_align_windowed_matches_plain(batch, n, dtype):
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_windowed, roi_align_windowed_reference,
    )
    device = _card()
    feats, rois, levels = _pyramid_800(batch, n, device, getattr(torch, dtype), seed=n)
    window_lib.reset_contract_stats()
    before = roi_align_windowed.launches
    got = roi_align_windowed(feats, rois, levels, ROI_STRIDES)
    torch.cuda.synchronize()
    assert roi_align_windowed.launches == before + 1
    stats = window_lib.contract_stats()
    want = roi_align_windowed_reference(feats, rois, levels, ROI_STRIDES)
    assert got.dtype == torch.float32 and got.shape == (batch, n, 256, 7, 7)
    assert torch.isfinite(got).all() and (got - want).abs().max().item() <= _roi_limit(want)
    mask = window_lib.windowed_out_of_contract_mask(
        rois, levels, [(f.shape[2], f.shape[3], s) for f, s in zip(feats, ROI_STRIDES)],
        channels=256, itemsize=feats[0].element_size())
    assert stats == {"rois": batch * n, "out_of_contract": int(mask.sum())}
    assert n < 4 or stats["out_of_contract"] >= 4
    window_lib.reset_contract_stats()


@pytest.mark.gpu
def test_roi_align_batched_bf16_matches_plain():
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched, roi_align_batched_reference,
    )
    device = _card()
    feats, rois, levels = _pyramid_800(8, 300, device, torch.bfloat16, seed=5)
    got = roi_align_batched(feats, rois, levels, ROI_STRIDES)
    torch.cuda.synchronize()
    want = roi_align_batched_reference(feats, rois, levels, ROI_STRIDES)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= _roi_limit(want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_800px_detector_on_cuda_goes_through_k9(dtype):
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    _card()
    detector = CaterDetector(DetectorConfig(compute_dtype=dtype))   # 800 px, "auto"
    frames = draw_frames(make_scene(0, num_frames=8))
    before = (rk.roi_align_windowed.launches, rk.roi_align_batched.launches)
    boxes, labels, scores, valid = detector(frames)
    assert (rk.roi_align_windowed.launches, rk.roi_align_batched.launches) == (
        before[0] + 1, before[1])
    assert boxes.shape == (8, 100, 4) and np.isfinite(boxes[valid]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,backend,forward", [("bfloat16", "windowed", "roi_align_windowed"),
                                                   ("float32", "windowed", "roi_align_windowed"),
                                                   ("bfloat16", "auto", "roi_align_batched")])
def test_800px_train_step_on_cuda_launches_its_forward_and_k8_once(dtype, backend, forward):
    """One full-width step of the train800 recipe (GroupNorm, 800 x 1088,
    B=2): K9 (windowed) or K7 ("auto") in the forward, K8 in the backward,
    once each; float32 master gradients."""
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    from objectpermanence_tpu_torch.models.detector import anchors as anchor_lib
    from objectpermanence_tpu_torch.models.detector.detector import (
        Detector, DetectorConfig, init_detector,
    )
    from objectpermanence_tpu_torch.models.detector.training import (
        make_detector_train_step, trainable_tensors,
    )
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
    from objectpermanence_tpu_torch.train.detector_loop import warmup_schedule
    device = _card()
    config = DetectorConfig(backbone_norm="group", rpn_pre_nms_top_n=500, rpn_post_nms_top_n=300,
                            roi_backend=backend, compute_dtype=dtype)
    model = init_detector(Detector(config)).to(device)
    tensors = [t for _, t in trainable_tensors(model)]
    optimizer = torch.optim.SGD(tensors, lr=5e-3, momentum=0.9, weight_decay=5e-4)
    anchors = [torch.from_numpy(a).to(device) for a in anchor_lib.pyramid_anchors(
        config.feature_shapes(), config.strides, config.anchor_sizes)]
    step = make_detector_train_step(config, anchors, optimizer, warmup_schedule(5e-3, 10))
    scene = make_scene(3, num_frames=20)
    images = torch.from_numpy(np.stack([draw_frames(scene, 3)[t] for t in (4, 12)])).float()
    vis = [np.flatnonzero(scene["visible"][t]) for t in (4, 12)]
    boxes = torch.zeros((2, 20, 4))
    labels = torch.zeros((2, 20), dtype=torch.int64)
    valid = torch.zeros((2, 20), dtype=torch.bool)
    for i, (t, v) in enumerate(zip((4, 12), vis)):
        boxes[i, :len(v)] = torch.from_numpy(scene["boxes"][t, v])
        labels[i, :len(v)] = torch.from_numpy(scene["classes"][v])
        valid[i, :len(v)] = True
    fwd = getattr(rk, forward)
    before = (fwd.launches, rk.roi_align_batched_backward.launches)
    parts = step(model, images.to(device), boxes.to(device), labels.to(device), valid.to(device),
                 generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    window_lib.reset_contract_stats()
    assert (fwd.launches, rk.roi_align_batched_backward.launches) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(v) for v in parts.values())
    assert all(t.dtype == torch.float32 and t.grad.dtype == torch.float32
               and torch.isfinite(t.grad).all() for t in tensors)


NATIVE_SHAPES = ((64, 80), (32, 40), (16, 20), (8, 10))
P800_SHAPES = ((200, 272), (100, 136), (50, 68), (25, 34))


def _levels_in(feats, layout):
    """The same values as `feats` in another memory layout: NCHW as given,
    channels_last, or a view whose x stride is 2 (neither)."""
    if layout == "channels_last":
        return [f.contiguous(memory_format=torch.channels_last) for f in feats]
    if layout == "strided":
        return [torch.stack([f, f], dim=-1)[..., 0] for f in feats]
    return feats


def _forward_case(batch, n, channels, shapes, dtype, device, seed):
    """Seeded levels of `shapes` in `dtype` and rois of every size class,
    with image 0's first rois: a sub-pixel roi whose samples share one
    pixel, a roi over the whole image (level-5 clamp: the whole P5), one
    outside the image and two 600 x 8 px (out of K9's contract)."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import assign_levels
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.standard_normal((batch, channels, h, w)).astype(np.float32)
                              * 100).to(device=device, dtype=dtype) for h, w in shapes]
    span = 4 * shapes[0][1]
    xy = rng.uniform(-40, span, (batch, n, 2))
    wh = np.exp(rng.uniform(np.log(0.3), np.log(span), (batch, n, 2)))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    edge = [[10.2, 20.7, 10.3, 20.8], [-5, -5, span + 5, span + 5], [-300, -300, -200, -200],
            [100, 200, 700, 208], [50, 100, 58, 700]]
    if n:
        rois[0, :min(n, len(edge))] = edge[:min(n, len(edge))]
    rois = torch.from_numpy(rois).to(device)
    return feats, rois, assign_levels(rois)


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [96, 200, 256])
@pytest.mark.parametrize("layout", ["nchw", "channels_last", "strided"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K7", "K9"])
def test_roi_align_forward_reads_every_layout(kernel, dtype, layout, channels):
    """K7 at the native and K9 at the 800 px pyramid, on ragged B and N,
    read levels as they lie in memory: bitwise equal to the NCHW call and
    to a second call, within 1e-4 x max of the plain version; K9's device
    count of out-of-contract rois equals the plain mask's; the launch used
    `launch_plan`'s plan."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
    device = _card()
    shapes = NATIVE_SHAPES if kernel == "K7" else P800_SHAPES
    feats, rois, levels = _forward_case(3, 57, channels, shapes, getattr(torch, dtype), device,
                                        seed=channels)
    fn, plain = ((rk.roi_align_batched, rk.roi_align_batched_reference) if kernel == "K7"
                 else (rk.roi_align_windowed, rk.roi_align_windowed_reference))
    levels_in = _levels_in(feats, layout)
    window_lib.reset_contract_stats()
    before = fn.launches
    got = fn(levels_in, rois, levels, ROI_STRIDES)
    again = fn(levels_in, rois, levels, ROI_STRIDES)
    nchw = fn(feats, rois, levels, ROI_STRIDES)
    torch.cuda.synchronize()
    assert fn.launches == before + 3
    plan = rk.launch_plan(channels, 7, 2, feats[0].element_size())
    assert rk.last_plan() == {k: plan[k] for k in ("slice", "threads", "smem", "tile_bytes",
                                                   "blocks")}
    want = plain(feats, rois, levels, ROI_STRIDES)
    assert got.dtype == torch.float32 and got.shape == (3, 57, channels, 7, 7)
    assert torch.isfinite(got).all() and (got - want).abs().max().item() <= _roi_limit(want)
    assert torch.equal(got, again) and torch.equal(got, nchw)
    if kernel == "K9":
        mask = window_lib.windowed_out_of_contract_mask(
            rois, levels, [(h, w, s) for (h, w), s in zip(shapes, ROI_STRIDES)],
            channels=channels, itemsize=feats[0].element_size())
        stats = window_lib.contract_stats()
        assert stats == {"rois": 3 * 3 * 57, "out_of_contract": 3 * int(mask.sum())}
        assert mask.sum() >= 2
    window_lib.reset_contract_stats()


@pytest.mark.gpu
@pytest.mark.parametrize("pooled,sampling", [(7, 2), (9, 3), (1, 32), (3, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_forward_largest_tiles(pooled, sampling, dtype):
    """K7, K5 and K6 at other pooled sizes and sampling ratios, up to the
    largest compact tile (2k x 2k pixels: the whole-image roi at the
    level-5 clamp over the 800 px P5, and pooled 9 x 3), against the plain
    version."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    from objectpermanence_tpu_torch.ops.roi_align import multilevel_roi_align
    device = _card()
    feats, rois, levels = _forward_case(2, 9, 64, P800_SHAPES, getattr(torch, dtype), device,
                                        seed=pooled * 100 + sampling)
    args = (feats, rois, levels, ROI_STRIDES, pooled, sampling)
    got = rk.roi_align_batched(*args)
    want = rk.roi_align_batched_reference(*args)
    one = ([f[0] for f in feats], rois[0], levels[0], ROI_STRIDES, pooled, sampling)
    single, tiled = rk.roi_align_single(*one), rk.roi_align_tiled(*one)
    torch.cuda.synchronize()
    assert got.shape == (2, 9, 64, pooled, pooled)
    assert (got - want).abs().max().item() <= _roi_limit(want)
    want_one = multilevel_roi_align([f[0].float() for f in feats], *one[1:])
    for out in (single, tiled):
        assert torch.equal(out, got[0]) and (out - want_one).abs().max().item() <= _roi_limit(
            want_one)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["roi_align_batched", "roi_align_windowed"])
def test_roi_align_forward_empty_rois_launch_nothing(kernel):
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    device = _card()
    feats, rois, levels = _forward_case(2, 0, 96, NATIVE_SHAPES, torch.float32, device, seed=1)
    fn = getattr(rk, kernel)
    before = fn.launches
    out = fn(feats, rois, levels, ROI_STRIDES)
    assert out.shape == (2, 0, 96, 7, 7) and fn.launches == before


K8_EDGE_ROIS = [[10.2, 20.7, 10.6, 21.1], [-30.0, 200.0, 25.0, 260.0], [300.0, -50.0, 420.0, 10.0],
                [-5.0, -5.0, 595.0, 600.0], [0.0, 0.0, 0.0, 0.0], [319.5, 255.5, 320.0, 256.0]]
# Odd level shapes (B, C, levels): 1 x 1 levels, one-row levels (a store of
# four where W allows), one-column levels (one value a store), and a single
# image of small levels, all at few channels (a part of one slice).
K8_ODD_LEVELS = {"level_1x1": (3, 16, ((1, 1),) * 4),
                 "level_1xw": (2, 8, ((1, 40), (1, 20), (1, 10), (1, 5))),
                 "level_hx1": (3, 3, ((64, 1), (32, 1), (16, 1), (8, 1))),
                 "single_image": (1, 3, ((5, 7), (4, 6), (2, 3), (1, 1)))}
K8_CASES = ["ragged", "edge", "one_level_p2", "one_level_p5", "identical", "crowded",
            "zero_dout", "c96", "c200", "pooled_3x1", "pooled_9x3", "pooled_4x4", "p800",
            *K8_ODD_LEVELS]


def _k8_case(case, device):
    """K8's inputs for `case`: (grad, rois, levels, shapes, sampling)."""
    batch, n, channels, pooled, sampling, shapes = 3, 57, 256, 7, 2, NATIVE_SHAPES
    if case in K8_ODD_LEVELS:
        batch, channels, shapes = K8_ODD_LEVELS[case]
    if case in ("c96", "c200"):
        channels = int(case[1:])
    if case.startswith("pooled"):
        pooled, sampling = (int(v) for v in case.split("_")[1].split("x"))
    if case == "identical":
        batch, n = 2, 320
    if case == "crowded":  # more rois on a tile than the kernel stages at a time (1024)
        batch, n = 1, 1100
    if case == "p800":
        batch, n, shapes = 4, 320, P800_SHAPES
    seed = K8_CASES.index(case)
    _, rois, levels = _forward_case(batch, n, 1, shapes, torch.float32, device, seed=seed)
    if case == "edge":
        from objectpermanence_tpu_torch.models.detector.roi_heads import assign_levels
        rois[0, :len(K8_EDGE_ROIS)] = torch.tensor(K8_EDGE_ROIS, device=device)
        levels = assign_levels(rois)
    if case.startswith("one_level"):
        levels.fill_(0 if case.endswith("p2") else 3)
    if case in ("identical", "crowded"):
        rois[:] = torch.tensor([100.0, 80.0, 160.0, 140.0], device=device)
        levels.fill_(0)
    rng = np.random.RandomState(seed)
    grad = torch.from_numpy(rng.standard_normal((batch, n, channels, pooled, pooled))
                            .astype(np.float32)).to(device)
    if case == "zero_dout":
        grad.zero_()
    return grad, rois, levels, [tuple(s) for s in shapes], sampling


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K8_CASES)
def test_roi_align_backward_cases_match_plain(case, dtype):
    """K8 against its plain version on `case`: float32 dF within 1e-4 x
    max(1, max |reference|), bf16 dF within one bf16 ulp of it; two calls
    bitwise equal; one launch a call, with `backward_launch_plan`'s plan."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    device = _card()
    grad, rois, levels, shapes, sampling = _k8_case(case, device)
    dt = getattr(torch, dtype)
    before = rk.roi_align_batched_backward.launches
    got = rk.roi_align_batched_backward(grad, rois, levels, shapes, ROI_STRIDES, sampling, dt)
    again = rk.roi_align_batched_backward(grad, rois, levels, shapes, ROI_STRIDES, sampling, dt)
    torch.cuda.synchronize()
    assert rk.roi_align_batched_backward.launches == before + 2
    plan = rk.backward_launch_plan(grad.shape[2], grad.shape[-1], sampling, got[0].element_size())
    assert rk.backward_last_plan() == {
        **{k: plan[k] for k in ("slice", "tile_h", "tile_w", "threads", "smem", "blocks")},
        "tiles": rk.backward_tile_count(shapes, plan["tile_w"])}
    want = rk.roi_align_batched_backward_reference(grad, rois, levels, shapes, ROI_STRIDES,
                                                   sampling)
    for g, a, w, (h, wd) in zip(got, again, want, shapes):
        assert g.dtype == dt and g.shape == (rois.shape[0], grad.shape[2], h, wd)
        assert g.is_contiguous() and torch.isfinite(g).all() and torch.equal(g, a)
        if dtype == "float32":
            assert (g - w).abs().max().item() <= _roi_limit(w)
        else:
            scale = w.abs().max().item()
            assert (g.float() - w.to(dt).float()).abs().max().item() <= (
                _bf16_ulp(scale) if scale else 0.0)
    if case == "zero_dout":
        assert all(not g.any() for g in got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_backward_clustered_rois_repeat_bitwise(dtype):
    """Many rois of different footprints on the same few tiles of P2 (each
    tile's list far longer than the ring of rois in flight, so every ring
    slot is reused many times), twenty calls: every call bitwise equal to
    the first, and within the limits of the plain version."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    device = _card()
    rng = np.random.RandomState(7)
    batch, n, channels = 2, 600, 64
    xy = rng.uniform(96.0, 160.0, (batch, n, 2))
    wh = rng.uniform(1.0, 60.0, (batch, n, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).to(device)
    levels = torch.zeros((batch, n), dtype=torch.int64, device=device)
    grad = torch.from_numpy(rng.standard_normal((batch, n, channels, 7, 7))
                            .astype(np.float32)).to(device)
    shapes, dt = list(NATIVE_SHAPES), getattr(torch, dtype)
    bins = rk.roi_align_backward_bins(rois, levels, shapes, ROI_STRIDES, dtype=dt)
    assert bins["counts"].max().item() >= 200
    first = rk.roi_align_batched_backward(grad, rois, levels, shapes, ROI_STRIDES, dtype=dt)
    for _ in range(19):
        again = rk.roi_align_batched_backward(grad, rois, levels, shapes, ROI_STRIDES, dtype=dt)
        assert all(torch.equal(a, f) for a, f in zip(again, first))
    want = rk.roi_align_batched_backward_reference(grad, rois, levels, shapes, ROI_STRIDES)
    for g, w in zip(first, want):
        if dtype == "float32":
            assert (g - w).abs().max().item() <= _roi_limit(w)
        else:
            scale = w.abs().max().item()
            assert (g.float() - w.to(dt).float()).abs().max().item() <= (
                _bf16_ulp(scale) if scale else 0.0)


@pytest.mark.gpu
def test_roi_align_backward_plan_is_the_library_plan():
    """`backward_launch_plan`, the CPU's copy of K8's plan, equals the
    library's own (`csrc/roi_align.cu::back_plan`) for every pooled size,
    sampling ratio and dF dtype, and refuses exactly what the library
    refuses."""
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    _card()
    for itemsize in (2, 4):
        for pooled in range(1, rk.MAX_POOLED + 2):
            for sampling in range(1, rk.MAX_SAMPLES + 2):
                own = rk.backward_library_plan(pooled, sampling, itemsize)
                try:
                    plan = rk.backward_launch_plan(1, pooled, sampling, itemsize)
                except ValueError:
                    assert own is None, (pooled, sampling, itemsize)
                    continue
                assert own is not None and own == {k: plan[k] for k in own}, (
                    pooled, sampling, itemsize)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["edge", "identical", "p800", "pooled_9x3"])
def test_roi_align_backward_bins_match_plain(case, dtype):
    """K8's binning on the card equals the plain binning at the tiles of dF
    in `dtype`: each tile's count and roi list, and each roi's sample table
    and footprint, bit for bit."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    device = _card()
    grad, rois, levels, shapes, sampling = _k8_case(case, device)
    pooled = grad.shape[-1]
    dt = getattr(torch, dtype)
    got = rk.roi_align_backward_bins(rois, levels, shapes, ROI_STRIDES, pooled, sampling, dt)
    want = rk.roi_align_backward_bins_reference(rois.cpu(), levels.cpu(), shapes, ROI_STRIDES,
                                                pooled, sampling, dt)
    torch.cuda.synchronize()
    assert torch.equal(got["counts"].cpu(), want["counts"])
    assert torch.equal(got["table"].cpu(), want["table"])
    listed = torch.arange(rois.shape[1])[None, None, :] < want["counts"][..., None]
    assert torch.equal(torch.where(listed, got["lists"].cpu(), -1), want["lists"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_backward_no_rois_writes_zeros(dtype):
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    device = _card()
    grad = torch.zeros((2, 0, 96, 7, 7), device=device)
    rois = torch.zeros((2, 0, 4), device=device)
    levels = torch.zeros((2, 0), dtype=torch.int64, device=device)
    before = rk.roi_align_batched_backward.launches
    got = rk.roi_align_batched_backward(grad, rois, levels, list(NATIVE_SHAPES), ROI_STRIDES,
                                        dtype=getattr(torch, dtype))
    assert rk.roi_align_batched_backward.launches == before
    assert [tuple(g.shape) for g in got] == [(2, 96, h, w) for h, w in NATIVE_SHAPES]
    assert all(g.dtype == getattr(torch, dtype) and not g.any() for g in got)


def _calibrated_siam(seed=0):
    """A seeded SiamRPN whose running statistics are fixture crops' batch
    statistics, so its scores do not saturate; with the crops' frames."""
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    from objectpermanence_tpu_torch.models import siam
    from objectpermanence_tpu_torch.train import siam_loop
    frames = draw_frames(make_scene(seed + 30, num_frames=8), seed=seed)
    z = np.stack([siam.get_subwindow(f, (160, 120), 100, 127, f.mean((0, 1))) for f in frames])
    x = np.stack([siam.get_subwindow(f, (160, 120), 200, 271, f.mean((0, 1))) for f in frames])
    model = siam_loop.siam_train_init(torch.Generator().manual_seed(seed))
    siam_loop.calibrate_batch_norm(model, torch.from_numpy(z).permute(0, 3, 1, 2).float(),
                                   torch.from_numpy(x).permute(0, 3, 1, 2).float())
    return model, frames


def _siam_close(got, want):
    return (got.cpu() - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("instance", [271, 287])
def test_siam_forward_on_card_matches_cpu(instance):
    import copy
    from objectpermanence_tpu_torch.models import siam
    device = _card()
    cpu, frames = _calibrated_siam()
    card = copy.deepcopy(cpu).to(device).eval()
    cpu.eval()
    z = siam.get_subwindow(frames[3], (150, 110), 90, 127, frames[3].mean((0, 1)))
    x = siam.get_subwindow(frames[4], (150, 110), 190, instance, frames[4].mean((0, 1)))
    z = torch.from_numpy(z).permute(2, 0, 1)[None].float()
    x = torch.from_numpy(x).permute(2, 0, 1)[None].float()
    with torch.inference_mode():
        want_k = cpu.temple(z)
        want = cpu.track_forward(want_k, x)
        got_k = card.temple(z.to(device))
        got = card.track_forward(got_k, x.to(device))
    for a, b in zip((*got_k, *got), (*want_k, *want)):
        assert a.device.type == "cuda" and _siam_close(a, b)


@pytest.mark.gpu
def test_siam_train_step_gradients_on_card_match_cpu():
    import copy
    from objectpermanence_tpu_torch.train import siam_loop
    device = _card()
    cpu, _ = _calibrated_siam(1)
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randint(0, 256, (8, 3, 127, 127)).astype(np.float32))
    x = torch.from_numpy(rng.randint(0, 256, (8, 3, 271, 271)).astype(np.float32))
    gt = torch.from_numpy(np.column_stack([rng.uniform(-30, 30, (8, 2)),
                                           rng.uniform(20, 80, (8, 2))]).astype(np.float32))
    _, xyxy = siam_loop.anchor_arrays()
    draws = torch.from_numpy(rng.uniform(0, 1, (2, 8, xyxy.shape[0])).astype(np.float32))
    masks = siam_loop.siam_pair_masks(gt, xyxy, draws[0], draws[1])
    grads = {}
    for dev, dtype in (("cpu", torch.float64), ("cpu", torch.float32), (device, torch.float32)):
        model = copy.deepcopy(cpu).to(dev, dtype)
        delta, score, _ = siam_loop.pair_forward_train(model, z.to(dev, dtype), x.to(dev, dtype))
        cxcywh, _ = siam_loop.anchor_arrays(dev)
        cls_l, reg_l = siam_loop.siam_pair_loss(delta, score, gt.to(dev, dtype), cxcywh.to(dtype),
                                                *(m.to(dev) for m in masks))
        (cls_l.mean() + reg_l.mean()).backward()
        grads[str(dev), dtype] = {n: p.grad.double().cpu() for n, p in model.named_parameters()}
    exact = grads["cpu", torch.float64]

    def distance(tag):
        return max((g - exact[n]).abs().max().item() / max(1.0, exact[n].abs().max().item())
                   for n, g in grads[tag, torch.float32].items())

    assert distance(str(device)) <= 2.0 * distance("cpu")


@pytest.mark.gpu
def test_tracker_over_a_fixture_video_matches_cpu():
    import copy
    from dataclasses import replace
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    from objectpermanence_tpu_torch.infer import trackers
    from objectpermanence_tpu_torch.models import siam
    device = _card()
    model, _ = _calibrated_siam(2)
    cpu = siam.SiamRPNTracker(copy.deepcopy(model), device="cpu")
    card = siam.SiamRPNTracker(model, device=device)
    scene = make_scene(9)
    frames = draw_frames(scene, seed=9)[..., ::-1]
    visible = scene["visible"]
    dets = {"bb": [scene["boxes"][t, visible[t]].astype(np.float32) for t in range(300)],
            "labels": [scene["classes"][visible[t]].astype(np.int64) for t in range(300)]}
    checked = {"frames": 0, "bad": []}

    class Replay:
        def init(self, im, pos, sz):
            self.card_kernels = card.init(im, pos, sz).kernels
            return cpu.init(im, pos, sz)

        def track(self, state, im):
            outs = [cpu.forward(state, im),
                    card.forward(replace(state, kernels=self.card_kernels), im)]
            want, got = (cpu.update(state, *out) for out in outs)
            pscore = [siam.penalized_scores(d, s, state.anchors, state.window, state.sz * scale,
                                            0.04, 0.44)[2] for d, s, scale in outs]
            best = [int(np.argmax(p)) for p in pscore]
            checked["frames"] += 1
            if best[0] != best[1]:
                if pscore[0][best[0]] - pscore[0][best[1]] > 1e-4:
                    checked["bad"].append(checked["frames"])
            elif max(np.abs(got.pos - want.pos).max(), np.abs(got.sz - want.sz).max()) > 0.1:
                checked["bad"].append(checked["frames"])
            return want

    before = opnet_fused_forward.launches + lstm_scan_hs.launches
    trackers.track_video(siam.ObjectDetectWithSiamTracker(Replay()), dets, 300,
                         lambda t: frames[t])
    torch.cuda.synchronize()
    assert opnet_fused_forward.launches + lstm_scan_hs.launches == before
    assert checked["frames"] >= 100 and not checked["bad"], checked
