"""Linear layer, the counterpart of `linear_init` / `linear_apply` in
`objectpermanence_tpu/ops/attention.py`. The weight keeps the JAX layout
`w (in, out)`; the bias, where there is one, is `b (out,)`.

A layer with a bias runs `linear_bias`. Without autograd it is one product
that adds the bias, and the ReLU where asked, in its epilogue
(`torch.addmm`, `torch._addmm_activation`: cuBLASLt's `BIAS` / `RELU_BIAS`
epilogues on the card), not a separate pass over the output for each. The
epilogue rounds fl(acc + b) from the fp32 accumulator, as the separate add
does, but cuBLASLt may pick another kernel than cuBLAS, which sums in
another order.

Under autograd (training) the product, the add and the ReLU stay separate
ops, as torch differentiates them: with the epilogue there, the other
summation order grew over the optimiser's steps into a loss gap 33 times
the limit of the train check against the fp32 reference, on one full run
in twelve (PERF.md).
"""

import math

import torch
from torch import nn


def linear_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                relu: bool = False) -> torch.Tensor:
    """`x (..., in) @ w (in, out) + b (out,)`, then ReLU where `relu`. Without
    autograd one product over `x`'s rows, counted in `linear_bias.launches`;
    under autograd the separate ops."""
    if torch.is_grad_enabled():
        y = torch.matmul(x, w) + b
        return torch.relu(y) if relu else y
    product = torch._addmm_activation if relu else torch.addmm
    y = product(b, x.reshape(-1, x.shape[-1]), w)
    linear_bias.launches += 1
    return y.reshape(*x.shape[:-1], w.shape[1])


linear_bias.launches = 0


class Linear(nn.Module):
    """`y = x @ w (+ b)`; U(-k, k) init with k = 1/sqrt(in) for both, as
    torch.nn.Linear. Bias-free unless `bias`, as the reasoning models' heads."""

    def __init__(self, in_dim: int, out_dim: int, generator=None, bias: bool = False):
        super().__init__()
        k = 1.0 / math.sqrt(in_dim)
        self.w = nn.Parameter(torch.empty(in_dim, out_dim).uniform_(-k, k, generator=generator))
        self.b = (nn.Parameter(torch.empty(out_dim).uniform_(-k, k, generator=generator))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w) if self.b is None else linear_bias(x, self.w, self.b)
