"""Bias-free LSTM, the counterpart of `objectpermanence_tpu/ops/lstm.py`.

Weights keep the JAX package's layout, `w_ih (D, 4H)` and `w_hh (H, 4H)`,
gate order `[i, f, g, o]` along the 4H axis (torch.nn.LSTM's
`weight_ih_l0.T` / `weight_hh_l0.T`), so parameters cross the weight
bridge without a transpose. On CUDA tensors `LSTM` runs the recurrence on
the kernels of `ops/lstm_scan.py`: `lstm_scan_fused` (K2 forward, K3
backward) when a gradient is recorded, the forward-only K4 otherwise. On
CPU tensors it runs `lstm_forward`, a plain time loop that autograd
differentiates. `StackedLSTM` is `num_layers` of them in a row.
"""

import math

import torch
from torch import nn

from objectpermanence_tpu_torch.ops.lstm_scan import lstm_scan_fused, lstm_scan_pallas


def lstm_cell(gates: torch.Tensor, c: torch.Tensor):
    """One LSTM step from pre-activation gates `(B, 4H)` and cell `(B, H)`;
    returns `(h, c)`."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_forward(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Run one layer over `x (B, T, D)` -> `(B, T, H)`. The input projection
    for the whole sequence is one product, as in `lstm_apply`."""
    batch, seq_len, _ = x.shape
    hidden = w_hh.shape[0]
    xproj = torch.matmul(x, w_ih)  # (B, T, 4H)
    h = x.new_zeros(batch, hidden)
    c = x.new_zeros(batch, hidden)
    hs = []
    for t in range(seq_len):
        h, c = lstm_cell(xproj[:, t] + h @ w_hh, c)
        hs.append(h)
    return torch.stack(hs, dim=1)


class LSTM(nn.Module):
    """Parameters `w_ih`, `w_hh` as in the JAX pytree; U(-k, k) init with
    k = 1/sqrt(H), as torch.nn.LSTM and `lstm_init`."""

    def __init__(self, input_dim: int, hidden_dim: int, generator=None):
        super().__init__()
        k = 1.0 / math.sqrt(hidden_dim)
        self.w_ih = nn.Parameter(
            torch.empty(input_dim, 4 * hidden_dim).uniform_(-k, k, generator=generator))
        self.w_hh = nn.Parameter(
            torch.empty(hidden_dim, 4 * hidden_dim).uniform_(-k, k, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return lstm_forward(x, self.w_ih, self.w_hh)
        params = {"w_ih": self.w_ih, "w_hh": self.w_hh}
        if torch.is_grad_enabled() and (x.requires_grad or self.w_ih.requires_grad
                                        or self.w_hh.requires_grad):
            return lstm_scan_fused(params, x)
        return lstm_scan_pallas(params, x)


class StackedLSTM(nn.ModuleList):
    """A multi-layer LSTM, as torch's `num_layers=k` with no dropout between
    layers (`stacked_lstm_init` / `stacked_lstm_apply`): layer 0 maps
    `input_dim` to `hidden_dim`, each later one `hidden_dim` to itself.
    Parameters are `<i>.w_ih`, `<i>.w_hh`, the JAX package's list of layers.
    Each layer is an `LSTM`, so on CUDA each runs its own kernels."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int, generator=None):
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        super().__init__(LSTM(d, hidden_dim, generator) for d in dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x)
        return x
