"""The benchmark's arithmetic against hand counts."""

import pytest
import torch

from benchmark import bounds, stats
from benchmark.models import opnet, transformer_lstm
from benchmark.reference.common import tf32

OPNET = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 256,
         "videos_hidden_dim": 512}
TLSTM = {"boxes_features_dim": 256, "num_attention_heads": 2, "num_attention_layers": 2,
         "num_lstm_layers": 2, "lstm_hidden_dim": 512, "ff_dim": 2048}


def test_k1_flops_at_the_served_batch():
    # 2 x 1,421,056 weights x 512 videos x 300 frames
    flops, _ = bounds.opnet_fused(batch=512)
    assert flops == 2 * 1_421_056 * 512 * 300 == 436_548_403_200  # 436.5 GFLOP
    assert opnet.flops_per_frame(OPNET) == 2 * 1_421_056


def test_k1_roofline_counts_the_whole_forward_and_its_projection():
    from types import SimpleNamespace

    from benchmark import readers
    from benchmark.tracing import Trace

    flops, bytes_ = bounds.opnet_fused(batch=512)
    # operations bound it: 6.516 ms against 0.86 ms of bytes
    assert bounds.least_seconds(flops, bytes_) == pytest.approx(6.5157e-3, rel=1e-4)
    ops = {"opnet_fused_kernel<float>": 0.030,
           "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_execute_kernel__5x_cublas": 0.002,
           "cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>": 0.001,
           "Memcpy": 0.004}
    trace = Trace(window_s=0.04, busy_s=0.037, calls=2, op_s=ops)
    assert trace.gemm_seconds() == pytest.approx(0.003)
    ctx = SimpleNamespace(config=OPNET, mix={"videos": 512, "frames": 300})
    run = SimpleNamespace(ctx=ctx, trace=trace)
    assert readers.k1_roofline(run) == pytest.approx(100 * 2 * 6.5157e-3 / 0.033, rel=1e-4)
    trace.op_s = {k: v for k, v in ops.items() if "opnet" not in k}
    assert readers.k1_roofline(run) is None  # no K1 in the stretch


def test_k4_bound_at_b400_h512():
    assert bounds.least_seconds(*bounds.lstm_forward(400, 300, 512, emit_cells=False)) \
        == pytest.approx(3.756e-3, rel=1e-3)


def test_k2_k3_bounds_of_opnet_train_step():
    total = sum(bounds.least_seconds(*bounds.lstm_forward(16, 300, h))
                + bounds.least_seconds(*bounds.lstm_backward(16, 300, h)) for h in (256, 512))
    # 37.6 + 112.7 us at H=256, 150.3 + 450.8 us at H=512
    assert total == pytest.approx(0.7514e-3, rel=1e-3)


def test_transformer_lstm_flops_by_hand():
    proj = 2 * 15 * 5 * 256
    full = 2 * 15 * 256 * 768 + 2 * 2 * 15 * 15 * 256 + 2 * 15 * 256 * 256 + 2 * 2 * 15 * 256 * 2048
    last = (2 * 15 * 256 * 512 + 2 * 256 * 256 + 2 * 2 * 15 * 256 + 2 * 256 * 256
            + 2 * 2 * 256 * 2048)
    lstms = 2 * 4 * 512 * (256 + 512) + 2 * 4 * 512 * (512 + 512)
    head = 2 * 512 * 4
    assert transformer_lstm.flops_per_frame(TLSTM) == proj + full + last + lstms + head \
        == 53_241_344


def test_nearest_rank_percentile():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    assert stats.percentile(list(range(20)), 95) == 18
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_window_arithmetic():
    from types import SimpleNamespace

    from benchmark import readers
    from benchmark.kinds import Window

    window = Window(attempted=40, frames=40 * 512 * 300, seconds=2.5,
                    host_call_s=[0.01, 0.03], latencies_s=[0.1] * 37 + [0.2, 0.3, 0.4])
    ctx = SimpleNamespace(adapter=opnet, config=OPNET, mix={"videos": 512, "frames": 300})
    run = SimpleNamespace(ctx=ctx, window=window, trace=None)
    assert readers.frames_per_s(run) == 40 * 512 * 300 / 2.5
    assert readers.host_ms_per_call(run) == pytest.approx(20.0)
    assert readers.p95_ms(run) == pytest.approx(200.0)  # the 38th of 40
    assert readers.mfu(run, passes=1) == pytest.approx(
        100 * 2_842_112 * 40 * 512 * 300 / 2.5 / 67e12)
    assert readers.device_idle(run) is None and readers.k1_roofline(run) is None


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**33 + 5])
def test_subseeds_are_fixed_and_apart(seed):
    a, b = stats.subseed(seed, "weights"), stats.subseed(seed, "inputs")
    assert a == stats.subseed(seed, "weights") and a != b
    assert 0 <= a < 2**63 and a != stats.subseed(seed + 1, "weights")
    torch.Generator().manual_seed(a)


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-12, 0.0])
    assert tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0, 0.0]
    w = torch.randn(64, 64, requires_grad=True)
    tf32(w).sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))
