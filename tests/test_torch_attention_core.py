"""`ops/attention_core.py` on the CPU: `MultiheadSelfAttention.forward`,
full and one-slot, is the composition it ran before the attention core had
a kernel (chunk, transposes, batched products, scale, softmax, transpose
back), bit for bit, with and without autograd; `reference_compat`'s long
sequences and every CPU tensor take the plain ops, so
`attention_core.launches` stays 0 off the card; the dispatch rule takes the
shipped shapes on a card and refuses fp64, autograd, head_dim not a
multiple of 4, and sequences beyond `MAX_LENGTH`. The kernel itself runs on
the card only (`tests/test_torch_kernels_gpu.py`).
"""

import math
import types

import pytest
import torch

from objectpermanence_tpu_torch.models.reasoning import TransformerLSTM
from objectpermanence_tpu_torch.ops import attention_core as core
from objectpermanence_tpu_torch.ops.attention import MultiheadSelfAttention
from objectpermanence_tpu_torch.ops.linear import linear_bias
from torch_lane import one_torch_thread  # noqa: F401

DIM, HEADS, TOKENS = 16, 2, 15


def _composition(attn, x, slot=None):
    """The forward as it was written before the core became one function."""
    n, length, dim = x.shape
    num_heads, head_dim = attn.w_in.shape[2], attn.w_in.shape[3]
    qkv = linear_bias(x, attn.w_in.reshape(dim, 3 * dim), attn.b_in.reshape(3 * dim))
    q, k, v = (t.reshape(n, length, num_heads, head_dim).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim), dim=-1)
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(n, length, dim)
    return attn.out(ctx if slot is None else ctx[:, slot])


def _attention(length=TOKENS, seed=0):
    attn = MultiheadSelfAttention(DIM, HEADS, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # biases away from their zero inits
        attn.b_in.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(seed + 1))
    x = torch.randn(6, length, DIM, generator=torch.Generator().manual_seed(seed + 2))
    return attn, x


def _on_a_card(length=TOKENS, dim=256, heads=2, dtype=torch.float32):
    """What the rule reads of a QKV product on a card, without a card."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 shape=(4, length, 3 * dim)), heads


def _same_forward(grad, slot, length=TOKENS):
    attn, x = _attention(length)
    runs = []
    for fn in (attn.forward, lambda x, slot: _composition(attn, x, slot)):
        inp = x.clone().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            y = fn(inp, slot)
            if grad:
                (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        runs.append([y.detach()] + ([inp.grad] + [p.grad for p in attn.parameters()]
                                    if grad else []))
        attn.zero_grad(set_to_none=True)
    assert runs[0][0].shape == ((6, DIM) if slot is not None else (6, length, DIM))
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def _transformer_launches(compat, train):
    config = {"boxes_features_dim": DIM, "num_attention_heads": HEADS,
              "num_attention_layers": 2, "num_lstm_layers": 2, "lstm_hidden_dim": 12}
    model = TransformerLSTM(config, torch.Generator().manual_seed(0),
                            reference_compat=compat).train(train)
    boxes = torch.rand(3, 12, 15, 5, generator=torch.Generator().manual_seed(1))
    before = core.attention_core.launches
    with torch.set_grad_enabled(train):
        model.forward_layers(boxes, torch.Generator().manual_seed(2))
    assert core.attention_core.launches == before


CASES = {
    "full_no_grad": lambda: _same_forward(False, None),
    "slot_no_grad": lambda: _same_forward(False, 7),
    "full_under_autograd": lambda: _same_forward(True, None),
    "slot_under_autograd": lambda: _same_forward(True, 0),
    "long_sequence_no_grad": lambda: _same_forward(False, 3, length=core.MAX_LENGTH + 8),
    "long_sequence_under_autograd": lambda: _same_forward(True, None, length=core.MAX_LENGTH + 8),
    "no_launch_off_the_card_eval": lambda: _transformer_launches(False, False),
    "no_launch_off_the_card_train": lambda: _transformer_launches(False, True),
    "no_launch_reference_compat": lambda: _transformer_launches(True, False),
    "rule_takes_the_shipped_shapes": lambda: _rule(True),
    "rule_refuses_the_cpu": lambda: _rule(False, device=torch.device("cpu")),
    "rule_refuses_fp64": lambda: _rule(False, dtype=torch.float64),
    "rule_refuses_autograd": lambda: _rule(False, grad=True),
    "rule_refuses_head_dim_6": lambda: _rule(False, dim=12, heads=2),
    "rule_refuses_head_dim_above_256": lambda: _rule(False, dim=520, heads=2),
    "rule_refuses_long_sequences": lambda: _rule(False, length=core.MAX_LENGTH + 1),
    "rule_takes_the_longest_sequence": lambda: _rule(True, length=core.MAX_LENGTH),
    "rule_refuses_a_slab_beyond_shared_memory": lambda: _rule(False, dim=1024, heads=8),
}


def _rule(takes, device=None, dtype=torch.float32, grad=False, length=TOKENS, dim=256, heads=2):
    qkv, num_heads = _on_a_card(length, dim, heads, dtype)
    if device is not None:
        qkv.device = device
    with torch.set_grad_enabled(grad):
        assert core.kernel_takes(qkv, num_heads) is takes


@pytest.mark.parametrize("case", list(CASES))
def test_attention_core_on_the_cpu(case):
    CASES[case]()
