"""The port's LSTM and linear layers against the JAX package's.

Inputs come from a numpy seed and go to both sides. Tolerance atol 1e-5:
both sides compute in float32 with the same gate arithmetic; only the
order of the sums inside the matrix products differs (Eigen vs ATen), a
few ulps per step over 12 steps.
"""

import jax
import numpy as np
import pytest
import torch

from objectpermanence_tpu.ops.attention import linear_apply
from objectpermanence_tpu.ops.lstm import lstm_apply
from objectpermanence_tpu_torch.ops.linear import Linear
from objectpermanence_tpu_torch.ops.lstm import LSTM, lstm_cell, lstm_forward

ATOL = 1e-5


def _lstm_inputs(seed, batch=5, seq_len=12, in_dim=30, hidden=32):
    rng = np.random.RandomState(seed)
    k = 1.0 / np.sqrt(hidden)
    params = {"w_ih": rng.uniform(-k, k, (in_dim, 4 * hidden)).astype(np.float32),
              "w_hh": rng.uniform(-k, k, (hidden, 4 * hidden)).astype(np.float32)}
    x = rng.randn(batch, seq_len, in_dim).astype(np.float32)
    return params, x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lstm_forward_matches_lstm_apply(seed):
    params, x = _lstm_inputs(seed)
    want = np.asarray(lstm_apply(params, x))
    got = lstm_forward(torch.from_numpy(x), torch.from_numpy(params["w_ih"]),
                       torch.from_numpy(params["w_hh"])).numpy()
    assert got.shape == want.shape == (5, 12, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_lstm_module_uses_jax_layout():
    params, x = _lstm_inputs(3)
    module = LSTM(30, 32)
    assert tuple(module.w_ih.shape) == (30, 128) and tuple(module.w_hh.shape) == (32, 128)
    assert float(module.w_hh.detach().abs().max()) <= 1.0 / np.sqrt(32)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(lstm_apply(params, x)), rtol=0, atol=ATOL)


def test_lstm_cell_gate_order():
    """Gates are [i, f, g, o]: with f saturated closed and i open the cell
    becomes tanh(g); o scales the output."""
    hidden = 3
    big = 30.0
    g = np.array([0.1, -0.5, 0.9], np.float32)
    gates = np.concatenate([np.full(hidden, big), np.full(hidden, -big), g,
                            np.zeros(hidden)]).astype(np.float32)[None]
    h, c = lstm_cell(torch.from_numpy(gates), torch.ones(1, hidden))
    np.testing.assert_allclose(c.numpy()[0], np.tanh(g), atol=1e-6)
    np.testing.assert_allclose(h.numpy()[0], 0.5 * np.tanh(np.tanh(g)), atol=1e-6)


def test_linear_matches_linear_apply():
    rng = np.random.RandomState(4)
    w = rng.randn(32, 15).astype(np.float32)
    x = rng.randn(5, 12, 32).astype(np.float32)
    layer = Linear(32, 15)
    layer.load_state_dict({"w": torch.from_numpy(w)})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    want = np.asarray(linear_apply({"w": jax.numpy.asarray(w)}, x))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
