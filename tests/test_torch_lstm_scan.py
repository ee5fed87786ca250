"""The port's LSTM recurrence kernels (`ops/lstm_scan.py`) against the JAX
package's, on the CPU, where the port runs their plain versions and the
Pallas kernels run in interpret mode.

Inputs come from a numpy seed and go to both sides. Tolerance rtol 1e-4,
atol 1e-6, as `tests/test_pallas_vjp.py`: both sides run float32 with the
same gate arithmetic; the products sum in another order (Eigen vs ATen).
The weight gradients add B x T such terms (up to 800 here, reaching ~20 in
magnitude), so they hold at atol 1e-5, as that file's batch-100 case does
for them. Widths are uneven (D=30,
H=32, so w_hh is 32 x 128): a transposed or gate-shuffled gradient cannot
pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import objectpermanence_tpu.ops.pallas_scan as ps
from objectpermanence_tpu.ops.lstm import lstm_apply
from objectpermanence_tpu_torch.ops.lstm import LSTM
from objectpermanence_tpu_torch.ops.lstm_scan import (
    lstm_scan_backward, lstm_scan_forward, lstm_scan_fused, lstm_scan_hs, lstm_scan_pallas,
)
from torch_lane import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-6
ATOL_WEIGHT_GRAD = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode():
    ps._INTERPRET_VJP = True
    yield
    ps._INTERPRET_VJP = False


def _case(seed, batch, seq_len=8, in_dim=30, hidden=32):
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(hidden)
    params = {"w_ih": rng.uniform(-k, k, (in_dim, 4 * hidden)).astype(np.float32),
              "w_hh": rng.uniform(-k, k, (hidden, 4 * hidden)).astype(np.float32)}
    x = rng.randn(batch, seq_len, in_dim).astype(np.float32)
    cotangent = rng.randn(batch, seq_len, hidden).astype(np.float32)
    return params, x, cotangent


def _t(a):
    """A contiguous, writable float32 CPU tensor of an array."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _xproj(x, w_ih):
    return np.ascontiguousarray(np.einsum("btd,dh->tbh", x, w_ih), dtype=np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=atol)


# batch 100 is not a multiple of the JAX backward's 64-row tile; 3 pads to 8
@pytest.mark.parametrize("batch", [100, 3])
def test_fused_values_and_grads_match_jax(batch):
    params, x, cotangent = _case(batch, batch)

    def loss(fn):
        return lambda p, xx: jnp.sum(fn(p, xx) * cotangent)

    want_fused = jax.grad(loss(ps.lstm_scan_fused), argnums=(0, 1))(params, x)
    want_scan = jax.grad(loss(lstm_apply), argnums=(0, 1))(params, x)

    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    out = lstm_scan_fused(leaves, xt)
    (out * torch.from_numpy(cotangent)).sum().backward()

    _close(out.detach(), ps.lstm_scan_fused(params, x))
    _close(out.detach(), lstm_apply(params, x))
    for want in (want_fused, want_scan):
        _close(leaves["w_ih"].grad, want[0]["w_ih"], ATOL_WEIGHT_GRAD)
        _close(leaves["w_hh"].grad, want[0]["w_hh"], ATOL_WEIGHT_GRAD)
        _close(xt.grad, want[1])


def test_forward_kernel_matches_pallas_forward():
    """K2 alone: `hs` and `cs` of `_lstm_fwd_pallas` on the same xproj."""
    params, x, _ = _case(5, 16)
    xproj = _xproj(x, params["w_ih"])
    want_hs, want_cs = ps._lstm_fwd_pallas(params["w_hh"], xproj, block_b=8, interpret=True)
    hs, cs = lstm_scan_forward(_t(xproj), _t(params["w_hh"]))
    _close(hs, want_hs)
    _close(cs, want_cs)


def test_backward_kernel_matches_pallas_backward():
    """K3 alone: `dxproj` and the summed per-tile `dW_hh` of
    `_lstm_bwd_pallas` on the same residuals (two 8-row tiles)."""
    params, x, cotangent = _case(6, 16)
    xproj = _xproj(x, params["w_ih"])
    hs, cs = (np.asarray(a) for a in ps._lstm_fwd_pallas(params["w_hh"], xproj, block_b=16,
                                                         interpret=True))
    h_prev = np.concatenate([np.zeros_like(hs[:1]), hs[:-1]])
    c_prev = np.concatenate([np.zeros_like(cs[:1]), cs[:-1]])
    dh_out = np.ascontiguousarray(np.swapaxes(cotangent, 0, 1))
    want_dxproj, want_parts = ps._lstm_bwd_pallas(params["w_hh"], xproj, h_prev, c_prev, cs,
                                                  dh_out, block_b=8, interpret=True)
    dxproj, d_w_hh = lstm_scan_backward(*(_t(a) for a in (
        xproj, h_prev, c_prev, cs, dh_out, params["w_hh"])))
    _close(dxproj, want_dxproj)
    _close(d_w_hh, np.sum(np.asarray(want_parts), axis=0), ATOL_WEIGHT_GRAD)


# the shapes of tests/test_pallas_scan.py, the second with a ragged batch
@pytest.mark.parametrize("batch,seq_len,in_dim,hidden", [(4, 12, 90, 256), (5, 7, 30, 128)])
def test_forward_only_matches_lstm_scan_pallas(batch, seq_len, in_dim, hidden):
    params, x, _ = _case(7, batch, seq_len, in_dim, hidden)
    want = ps.lstm_scan_pallas(params, x, block_b=8, interpret=True)
    got = lstm_scan_pallas({k: torch.from_numpy(v) for k, v in params.items()},
                           torch.from_numpy(x))
    assert got.shape == want.shape == (batch, seq_len, hidden)
    assert not got.requires_grad
    _close(got, want)
    _close(got, lstm_apply(params, x))


def test_cpu_tensors_count_no_launch():
    params, x, _ = _case(8, 4)
    xproj, w_hh = _t(_xproj(x, params["w_ih"])), _t(params["w_hh"])
    before = (lstm_scan_forward.launches, lstm_scan_hs.launches, lstm_scan_backward.launches)
    hs, cs = lstm_scan_forward(xproj, w_hh)
    lstm_scan_hs(xproj, w_hh)
    lstm_scan_backward(xproj, hs, cs, cs, hs, w_hh)
    assert (lstm_scan_forward.launches, lstm_scan_hs.launches,
            lstm_scan_backward.launches) == before


@pytest.mark.parametrize("bad", ["float64", "strided", "shape", "meta"])
def test_wrappers_refuse_what_the_kernel_does_not_take(bad):
    xproj = torch.zeros(6, 3, 4 * 8)
    w_hh = torch.zeros(8, 4 * 8)
    if bad == "float64":
        xproj, error = xproj.double(), TypeError
    elif bad == "strided":
        xproj, error = torch.zeros(3, 6, 32).transpose(0, 1), ValueError
    elif bad == "shape":
        w_hh, error = torch.zeros(8, 24), ValueError
    else:  # neither the card nor the CPU: no plain path to fall back on
        xproj, w_hh, error = xproj.to("meta"), w_hh.to("meta"), ValueError
    with pytest.raises(error):
        lstm_scan_forward(xproj, w_hh)
    with pytest.raises(error):
        lstm_scan_hs(xproj, w_hh)


def test_lstm_module_matches_fused_layer_on_cpu():
    """`LSTM` on CPU tensors (the autograd step loop) gives the values and
    gradients of `lstm_scan_fused`."""
    params, x, cotangent = _case(9, 5)
    module = LSTM(30, 32)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    out = module(torch.from_numpy(x))
    (out * torch.from_numpy(cotangent)).sum().backward()
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    fused = lstm_scan_fused(leaves, torch.from_numpy(x))
    (fused * torch.from_numpy(cotangent)).sum().backward()
    _close(out.detach(), fused.detach())
    _close(module.w_ih.grad, leaves["w_ih"].grad, ATOL_WEIGHT_GRAD)
    _close(module.w_hh.grad, leaves["w_hh"].grad, ATOL_WEIGHT_GRAD)
