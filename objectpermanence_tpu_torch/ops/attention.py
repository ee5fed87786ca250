"""Object self-attention, the counterpart of
`objectpermanence_tpu/ops/attention.py`: LayerNorm, multi-head
self-attention and the post-LN transformer encoder of `TransformerLSTM`.

Parameters keep the JAX pytree's names and shapes, so the weight bridge
copies them as they are: `attn.w_in (D, 3, heads, head_dim)`, `attn.b_in
(3, heads, head_dim)`, `attn.out.{w,b}`, `ff1.{w,b}`, `ff2.{w,b}`,
`norm1.{scale,bias}`, `norm2.{scale,bias}`. The settings are
torch.nn.TransformerEncoderLayer's: ReLU, ff 2048, dropout 0.1, LayerNorm
eps 1e-5. The JAX package wrote no Pallas kernel for attention: the
sequences are 15 tokens. Its products with a bias (the in- and
out-projections, `ff1` with its ReLU, `ff2`) run `ops/linear.py::linear_bias`:
outside autograd the bias and the ReLU are added in the product's epilogue.
Between the in- and the out-projection, the attention core
(`ops/attention_core.py`) is one kernel on the card outside autograd, which
reads the QKV product in place, and the plain composition elsewhere.

Dropout runs only in train mode and draws its mask from the `generator`
the caller passes (on the tensors' device); in eval mode it is the
identity, as `deterministic=True` in JAX.

A caller that reads one slot of the encoder's output passes `slot`: the
last layer then runs its out-projection, both LayerNorms and the
feed-forward, most of its work, on that slot's rows alone. Its attention
core computes that slot's query alone where the kernel runs (the row is the
kernel's full form's row bit for bit). Under autograd the plain composition
keeps its full shapes and slices the slot after it: on the card a one-query
product runs on other kernels (cuBLAS's gemv), which sum in another order,
and a train step then moves the weights whose gradient is at round-off
(elements of `box_proj.w`) away from where the full form moves them. Its
dropout masks are still drawn over the full shape and sliced, so the draws
and the generator's state after them are the full form's.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from objectpermanence_tpu_torch.ops.attention_core import attention_core
from objectpermanence_tpu_torch.ops.linear import Linear, linear_bias
from objectpermanence_tpu_torch.utils import trace

DROPOUT_RATE = 0.1
FF_DIM = 2048
LAYERNORM_EPS = 1e-5


def dropout(x: torch.Tensor, rate: float, generator=None, slot=None,
            length=None) -> torch.Tensor:
    """Zero each element with probability `rate` and scale the rest by
    1 / (1 - rate), the mask drawn from `generator`. With `slot`, `x (N, C)`
    is slot `slot` of an `(N, length, C)` tensor: the mask is drawn over that
    whole shape and its slot taken."""
    shape = x.shape if slot is None else (x.shape[0], length, x.shape[-1])
    draw = torch.rand(shape, generator=generator, device=x.device)
    keep = (draw if slot is None else draw[:, slot]) >= rate
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

    def forward(self, x: torch.Tensor, slot=None) -> torch.Tensor:
        """Self-attention over `x (N, L, D)`; with `slot`, the out-projection
        of slot `slot`'s rows alone, `(N, D)`."""
        dim = x.shape[-1]
        qkv = linear_bias(x, self.w_in.reshape(dim, 3 * dim), self.b_in.reshape(3 * dim))
        return self.out(attention_core(qkv, self.w_in.shape[2], slot))


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

    def forward(self, x: torch.Tensor, generator=None, slot=None) -> torch.Tensor:
        """`x (N, L, D)` -> `(N, L, D)`; with `slot`, slot `slot`'s rows alone,
        `(N, D)`."""
        length = x.shape[1]

        def drop(t):
            return dropout(t, DROPOUT_RATE, generator, slot, length) if self.training else t

        residual = x if slot is None else x[:, slot]
        x = self.norm1(residual + drop(self.attn(x, slot)))
        ff = self.ff2(drop(linear_bias(x, self.ff1.w, self.ff1.b, relu=True)))
        return self.norm2(x + drop(ff))


class Encoder(nn.ModuleList):
    """`num_layers` encoder layers in a row (`encoder_init` / `encoder_apply`),
    in the span `objperm.model.encoder` with its device interval."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, ff_dim: int = FF_DIM,
                 generator=None):
        super().__init__(EncoderLayer(dim, num_heads, ff_dim, generator)
                         for _ in range(num_layers))

    def forward(self, x: torch.Tensor, generator=None, slot=None) -> torch.Tensor:
        """`x (N, L, D)` -> `(N, L, D)`; with `slot`, the last layer runs its
        out-projection, LayerNorms and feed-forward on slot `slot`'s rows
        alone and the encoder returns them, `(N, D)`."""
        last = len(self) - 1
        with trace.span("objperm.model.encoder", x.device):
            for i, layer in enumerate(self):
                x = layer(x, generator, slot if i == last else None)
        return x
