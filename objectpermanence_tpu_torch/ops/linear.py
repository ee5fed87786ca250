"""Linear layer, the counterpart of `linear_init` / `linear_apply` in
`objectpermanence_tpu/ops/attention.py`. The weight keeps the JAX layout
`w (in, out)`; the bias, where there is one, is `b (out,)`."""

import math

import torch
from torch import nn


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
        y = torch.matmul(x, self.w)
        return y if self.b is None else y + self.b
