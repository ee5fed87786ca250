"""Object self-attention, the counterpart of
`objectpermanence_tpu/ops/attention.py`: LayerNorm, multi-head
self-attention and the post-LN transformer encoder of `TransformerLSTM`.

Parameters keep the JAX pytree's names and shapes, so the weight bridge
copies them as they are: `attn.w_in (D, 3, heads, head_dim)`, `attn.b_in
(3, heads, head_dim)`, `attn.out.{w,b}`, `ff1.{w,b}`, `ff2.{w,b}`,
`norm1.{scale,bias}`, `norm2.{scale,bias}`. The settings are
torch.nn.TransformerEncoderLayer's: ReLU, ff 2048, dropout 0.1, LayerNorm
eps 1e-5. The JAX package wrote no Pallas kernel for attention: the
sequences are 15 tokens, so this is plain tensor code on every device.

Dropout runs only in train mode and draws its mask from the `generator`
the caller passes (on the tensors' device); in eval mode it is the
identity, as `deterministic=True` in JAX.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from objectpermanence_tpu_torch.ops.linear import Linear

DROPOUT_RATE = 0.1
FF_DIM = 2048
LAYERNORM_EPS = 1e-5


def dropout(x: torch.Tensor, rate: float, generator=None) -> torch.Tensor:
    """Zero each element with probability `rate` and scale the rest by
    1 / (1 - rate), the mask drawn from `generator`."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis; parameters `scale` (ones), `bias` (zeros)."""

    def __init__(self, dim: int, eps: float = LAYERNORM_EPS):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class MultiheadSelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's layout: a fused in-projection, xavier
    uniform over torch's stacked (3D, D) weight with a zero bias, and an
    out-projection with a zero bias. The head count is `w_in`'s third axis."""

    def __init__(self, dim: int, num_heads: int, generator=None):
        super().__init__()
        assert dim % num_heads == 0
        head_dim = dim // num_heads
        bound = math.sqrt(6.0 / (3 * dim + dim))
        self.w_in = nn.Parameter(torch.empty(dim, 3, num_heads, head_dim).uniform_(
            -bound, bound, generator=generator))
        self.b_in = nn.Parameter(torch.zeros(3, num_heads, head_dim))
        self.out = Linear(dim, dim, generator, bias=True)
        with torch.no_grad():
            self.out.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Self-attention over `x (N, L, D)`."""
        n, length, dim = x.shape
        num_heads, head_dim = self.w_in.shape[2], self.w_in.shape[3]
        qkv = torch.matmul(x, self.w_in.reshape(dim, 3 * dim)) + self.b_in.reshape(3 * dim)
        q, k, v = (t.reshape(n, length, num_heads, head_dim).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim), dim=-1)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(n, length, dim)
        return self.out(ctx)


class EncoderLayer(nn.Module):
    """Post-LN encoder layer with torch's dropouts: on the attention output,
    inside the feed-forward block and on its output."""

    def __init__(self, dim: int, num_heads: int, ff_dim: int = FF_DIM, generator=None):
        super().__init__()
        self.attn = MultiheadSelfAttention(dim, num_heads, generator)
        self.ff1 = Linear(dim, ff_dim, generator, bias=True)
        self.ff2 = Linear(ff_dim, dim, generator, bias=True)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        def drop(t):
            return dropout(t, DROPOUT_RATE, generator) if self.training else t

        x = self.norm1(x + drop(self.attn(x)))
        ff = self.ff2(drop(torch.relu(self.ff1(x))))
        return self.norm2(x + drop(ff))


class Encoder(nn.ModuleList):
    """`num_layers` encoder layers in a row (`encoder_init` / `encoder_apply`)."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, ff_dim: int = FF_DIM,
                 generator=None):
        super().__init__(EncoderLayer(dim, num_heads, ff_dim, generator)
                         for _ in range(num_layers))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for layer in self:
            x = layer(x, generator)
        return x
