"""Bias-free linear layer, the counterpart of `linear_init` / `linear_apply`
in `objectpermanence_tpu/ops/attention.py`. The weight keeps the JAX
layout `w (in, out)`."""

import math

import torch
from torch import nn


class Linear(nn.Module):
    """`y = x @ w`; U(-k, k) init with k = 1/sqrt(in), as torch.nn.Linear."""

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        k = 1.0 / math.sqrt(in_dim)
        self.w = nn.Parameter(torch.empty(in_dim, out_dim).uniform_(-k, k, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w)
