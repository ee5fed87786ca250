"""The bf16 operand mode of the port's fused OPNet forward (K1's bf16 mode)
against the JAX package's, on the CPU.

JAX's `opnet_fused_forward(..., compute_dtype=jnp.bfloat16)` runs its
Pallas kernel in interpret mode, as `tests/test_pallas_scan.py` runs it:
it rounds the six weights to bf16, rounds the boxes to bf16 (the scene of
its bf16 input product, whose float32 sum is rounded to bf16, and the boxes
the attention selects from), and keeps the carries, the sums, the softmax
and the outputs float32. The port's plain version (`opnet_forward_reference`
with `compute_dtype=torch.bfloat16`, what a CPU tensor runs) rounds the same
operands and runs its float32 step loop: the same function of the same bf16
values, with sums in another order. So it is held at the float32 tests'
tolerances (`tests/test_torch_opnet.py`): atol 1e-5 on `y`, atol 1e-5 plus
rtol 2e-6 on the logits (measured at the narrow width: 1.4e-6 on `y`,
6e-8 on the logits).

- At narrow widths on random boxes, and at the flagship's full width on
  served boxes (T cut to 12 frames: JAX's interpret mode runs one grid
  step per frame).
- bf16 stays within 5% of float32 relative to max |y|, the bound of JAX's
  own bf16 test (`tests/test_pallas_scan.py:77-94`).
- `make_predict_step(compute_dtype=torch.bfloat16)` on the CPU equals
  JAX's `make_predict_step(compute_dtype=jnp.bfloat16)`, which ignores it
  off the TPU (its XLA path), as the port ignores it off the card.
- An unsupported compute dtype raises at every entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectpermanence_tpu.infer.reasoning import make_predict_step as jax_make_predict_step
from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
from objectpermanence_tpu.ops.pallas_scan import opnet_fused_forward as jax_opnet_fused_forward
from objectpermanence_tpu_torch.infer.reasoning import make_predict_step
from objectpermanence_tpu_torch.models.convert import params_from_jax
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.ops.opnet_fused import opnet_forward_reference, opnet_fused_forward
from test_torch_opnet import (
    FULL, NARROW, _bench_boxes, _flagship, _model, _random_boxes, _random_params, _unflatten,
)
from torch_lane import one_torch_thread  # noqa: F401

ATOL = 1e-5
LOGITS_RTOL = 2e-6
JAX_BF16_REL = 0.05   # tests/test_pallas_scan.py: bf16 within 5% of float32
KEYS = ("att_lstm.w_ih", "att_lstm.w_hh", "att_head.w", "video_lstm.w_ih", "video_lstm.w_hh",
        "box_head.w")


def _case(name):
    if name == "narrow":
        return _random_params(NARROW, 3), _random_boxes(4, batch=5, seq_len=20)
    return _unflatten(_flagship()), np.ascontiguousarray(_bench_boxes(3)[:, :12])


def _weights(params):
    state = params_from_jax(params)
    return [state[k] for k in KEYS]


@pytest.mark.parametrize("name", ["narrow", "flagship"])
def test_plain_bf16_loop_matches_jax_interpret_kernel(name):
    params, boxes = _case(name)
    want_y, want_logits = (np.asarray(a) for a in jax_opnet_fused_forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(boxes), block_b=8, interpret=True,
        compute_dtype=jnp.bfloat16))
    before = opnet_fused_forward.launches
    y, logits = opnet_fused_forward(torch.from_numpy(boxes), *_weights(params),
                                    compute_dtype=torch.bfloat16)
    assert opnet_fused_forward.launches == before  # a CPU tensor runs the plain version
    assert y.dtype == logits.dtype == torch.float32  # outputs stay float32, as JAX's
    assert y.shape == want_y.shape and logits.shape == want_logits.shape
    np.testing.assert_allclose(y.numpy(), want_y, rtol=0, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=LOGITS_RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["narrow", "flagship"])
def test_bf16_stays_near_float32(name):
    params, boxes = _case(name)
    weights = _weights(params)
    y32, _ = opnet_forward_reference(torch.from_numpy(boxes), *weights)
    y16, _ = opnet_forward_reference(torch.from_numpy(boxes), *weights,
                                     compute_dtype=torch.bfloat16)
    rel = float((y16 - y32).abs().max() / y32.abs().max())
    assert 0 < rel < JAX_BF16_REL


def test_make_predict_step_bf16_on_cpu_equals_jax():
    params = _unflatten(_flagship())
    boxes = _bench_boxes()
    jax_step = jax_make_predict_step(jax_get_model_spec("opnet"), compute_dtype=jnp.bfloat16)
    want = np.asarray(jax_step(jax.tree.map(jnp.asarray, params), boxes))
    spec = get_model_spec("opnet")
    model = _model(FULL, params)
    got = make_predict_step(spec, device="cpu", compute_dtype=torch.bfloat16)(model, boxes)
    fp32 = make_predict_step(spec, device="cpu")(model, boxes)
    assert torch.equal(got, fp32)  # ignored off the card, as JAX ignores it off the TPU
    diff = np.abs(got.numpy().astype(np.int64) - want)
    assert got.shape == want.shape == (8, 300, 4)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("entry", ["opnet_fused_forward", "model", "make_predict_step"])
def test_unsupported_compute_dtype_raises(entry, dtype):
    params = _random_params(NARROW, 5)
    boxes = torch.from_numpy(_random_boxes(6, batch=2, seq_len=4))
    calls = {"opnet_fused_forward": lambda: opnet_fused_forward(boxes, *_weights(params),
                                                                compute_dtype=dtype),
             "model": lambda: _model(NARROW, params)(boxes, compute_dtype=dtype),
             "make_predict_step": lambda: make_predict_step(get_model_spec("opnet"),
                                                            device="cpu", compute_dtype=dtype)}
    with pytest.raises(TypeError, match="compute_dtype"):
        calls[entry]()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_operands_are_contiguous_unit_major_and_rounded(dtype):
    """What the wrapper hands the kernel on the card, built here on the CPU:
    every operand contiguous in the compute dtype, the LSTM weights and
    xproj1 unit-major (column 4u + gate), W_att and W_head transposed, and
    xproj1 the plain version's rounded product."""
    from objectpermanence_tpu_torch.ops.opnet_fused import kernel_operands
    params = _random_params(NARROW, 9)
    weights = _weights(params)
    w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head = weights
    boxes = torch.from_numpy(_random_boxes(10, batch=3, seq_len=7))
    operands = kernel_operands(boxes, *weights, compute_dtype=dtype)
    assert all(x.dtype == dtype and x.is_contiguous() for x in operands)
    xproj1, boxes_k, w1_hh_u, w_att_t, w2_ih_u, w2_hh_u, w_head_t = operands

    def gate_major(u):  # unit-major (.., 4u + gate) -> gate-major (.., gate * H + u)
        return u.view(*u.shape[:-1], -1, 4).transpose(-1, -2).reshape(u.shape)

    def rounded(x):
        return x.to(dtype)

    assert torch.equal(boxes_k, rounded(boxes))
    for got, want in ((w1_hh_u, w1_hh), (w2_ih_u, w2_ih), (w2_hh_u, w2_hh)):
        assert torch.equal(gate_major(got), rounded(want))
    assert torch.equal(w_att_t, rounded(w_att.t())) and torch.equal(w_head_t, rounded(w_head.t()))
    scene = rounded(boxes).float().reshape(3, 7, -1)
    want = rounded(scene @ rounded(w1_ih).float())
    got = gate_major(xproj1)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)  # the same product, rounded once
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
