"""The Switch-style mixture-of-experts box head of `opnet_moe`, the
counterpart of the dense single-device head in
`objectpermanence_tpu/parallel/expert.py` (`moe_head_init`, `moe_route`,
`moe_head_apply`, `moe_balance_loss`). The expert-parallel layers beside it
there are not ported yet (ROADMAP.md, Next slices, item 7).

A router picks one expert per token (top-1; a tie goes to the first index,
as `jnp.argmax`), every expert's two-layer MLP runs on every token, and the
chosen expert's output is scaled by its router probability, so gradients
reach the router through that probability. All layers are bias-free.
Parameters keep the JAX names and shapes: `router (in, E)`, `w1 (E, in,
hidden)`, `w2 (E, hidden, out)`.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def moe_route(router: torch.Tensor, h: torch.Tensor):
    """-> (top-1 expert `(...,)`, its probability `(...,)`, router probs `(..., E)`)."""
    probs = torch.softmax(torch.matmul(h, router), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    gate = probs.gather(-1, top1.unsqueeze(-1)).squeeze(-1)
    return top1, gate, probs


def moe_balance_loss(probs: torch.Tensor, token_weight: torch.Tensor = None) -> torch.Tensor:
    """Switch Transformers' load-balance term (Fedus et al. 2021, eq. 4-6)
    from router probs `(..., E)`: `E * sum_e f_e * P_e`, `f_e` the share of
    tokens whose top-1 expert is `e`, `P_e` the mean probability on `e`. It
    is 1 at uniform routing. `token_weight`, broadcastable to the token
    axes (the train step's `(B,)` sample weights), makes both weighted means,
    so the rows that pad a ragged batch count for nothing."""
    num_experts = probs.shape[-1]
    token_axes = tuple(range(probs.dim() - 1))
    onehot = F.one_hot(torch.argmax(probs, dim=-1), num_experts).to(probs.dtype)
    if token_weight is None:
        f = onehot.mean(dim=token_axes)
        p = probs.mean(dim=token_axes)
    else:
        w = token_weight.to(probs.dtype)
        w = w.reshape(w.shape + (1,) * (probs.dim() - w.dim())).expand(probs.shape)
        denom = torch.clamp(w.sum(dim=token_axes), min=1e-6)
        f = (onehot * w).sum(dim=token_axes) / denom
        p = (probs * w).sum(dim=token_axes) / denom
    return num_experts * (f * p).sum()


class MoEHead(nn.Module):
    """Router `Linear(in -> E)` and E experts `in -> hidden -> out` (ReLU)."""

    def __init__(self, in_dim: int, out_dim: int, num_experts: int = 4,
                 expert_hidden: int = 128, generator=None):
        super().__init__()
        k_in, k_hidden = 1.0 / math.sqrt(in_dim), 1.0 / math.sqrt(expert_hidden)
        self.router = nn.Parameter(torch.empty(in_dim, num_experts).uniform_(
            -k_in, k_in, generator=generator))
        self.w1 = nn.Parameter(torch.empty(num_experts, in_dim, expert_hidden).uniform_(
            -k_in, k_in, generator=generator))
        self.w2 = nn.Parameter(torch.empty(num_experts, expert_hidden, out_dim).uniform_(
            -k_hidden, k_hidden, generator=generator))

    def forward(self, h: torch.Tensor, return_probs: bool = False):
        """`h (..., in)` -> `(..., out)`, and the router probs with `return_probs`."""
        top1, gate, probs = moe_route(self.router, h)
        hidden = torch.relu(torch.einsum("...i,eih->e...h", h, self.w1))
        outs = torch.einsum("e...h,eho->e...o", hidden, self.w2)
        onehot = F.one_hot(top1, self.w1.shape[0]).to(h.dtype)
        out = torch.einsum("e...o,...e->...o", outs, onehot) * gate.unsqueeze(-1)
        return (out, probs) if return_probs else out
