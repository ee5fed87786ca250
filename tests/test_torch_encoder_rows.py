"""The encoder's one-slot form (`ops/attention.py`, `slot=`) against its
full form on the CPU: the last layer's attention runs over every slot and
its out-projection, LayerNorms and feed-forward on the read slot's rows
alone, so its output equals the full form's slot within float32 round-off
(the same products, on fewer rows: atol and rtol 1e-5 on LayerNorm outputs
of order 1). In train mode
the masks are drawn over the full shapes and sliced, so both forms leave
the generator in the same state and zero the same elements.

Also: `TransformerLSTM.forward_layers` takes the one-slot form (the last
layer's feed-forward sees B*T rows) and `reference_compat` the full one.
"""

import pytest
import torch

from objectpermanence_tpu_torch.models.reasoning import TransformerLSTM
from objectpermanence_tpu_torch.ops.attention import Encoder, dropout

# (features, heads, feed-forward, sequences): a small layer, and the
# published transformer_lstm widths over 15 object tokens
SIZES = [(8, 2, 32, 6), (256, 2, 2048, 48)]
TOKENS = 15


def _encoder(dim, heads, ff_dim, seed=0):
    encoder = Encoder(2, dim, heads, ff_dim, torch.Generator().manual_seed(seed))
    draw = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # biases and norms away from their zero / one inits
        for name, param in encoder.named_parameters():
            if param.dim() < 2 or name.endswith("b_in"):
                param.uniform_(-0.5, 0.5, generator=draw)
    return encoder


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("dim,heads,ff_dim,n", SIZES, ids=["d8", "d256_published"])
@pytest.mark.parametrize("slot", [0, 7])
def test_one_slot_form_matches_the_full_form(dim, heads, ff_dim, n, mode, slot):
    encoder = _encoder(dim, heads, ff_dim).train(mode == "train")
    x = torch.randn(n, TOKENS, dim, generator=torch.Generator().manual_seed(2))
    full_gen, slot_gen = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    x_full, x_slot = x.clone().requires_grad_(), x.clone().requires_grad_()
    full = encoder(x_full, full_gen)
    got = encoder(x_slot, slot_gen, slot=slot)
    assert full.shape == (n, TOKENS, dim) and got.shape == (n, dim)
    torch.testing.assert_close(got, full[:, slot], rtol=1e-5, atol=1e-5)
    assert torch.equal(full_gen.get_state(), slot_gen.get_state())
    if mode == "train":  # dropout did act: the eval output differs
        with torch.no_grad():
            assert (encoder.eval()(x, slot=slot) - got).abs().max() > 1e-3

    # the same gradients: what the full form spends on unread rows is zero
    grads = []
    for out, inp in ((full[:, slot], x_full), (got, x_slot)):
        encoder.zero_grad()
        (out * torch.linspace(-1, 1, dim)).sum().backward()
        grads.append([inp.grad] + [p.grad.clone() for p in encoder.parameters()])
    for g_full, g_slot in zip(*grads):
        torch.testing.assert_close(g_slot, g_full, rtol=1e-5,
                                   atol=1e-5 * max(1.0, g_full.abs().max().item()))


@pytest.mark.parametrize("slot", [0, 3, TOKENS - 1])
def test_one_slot_dropout_is_the_full_masks_slot(slot):
    x = torch.randn(40, TOKENS, 24, generator=torch.Generator().manual_seed(1))
    full_gen, slot_gen = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    full = dropout(x, 0.1, full_gen)
    got = dropout(x[:, slot], 0.1, slot_gen, slot, TOKENS)
    assert torch.equal(got, full[:, slot])
    assert torch.equal(full_gen.get_state(), slot_gen.get_state())


CONFIG = {"boxes_features_dim": 16, "num_attention_heads": 2, "num_attention_layers": 2,
          "num_lstm_layers": 2, "lstm_hidden_dim": 12}


@pytest.mark.parametrize("compat", [False, True], ids=["per_frame", "reference_compat"])
def test_forward_layers_cuts_the_last_layer_to_slot_0(compat):
    """Hooks on each layer's out-projection and `ff2`: the first layer's see
    every token; the last layer's see the B*T snitch rows on the per-frame
    path, and every token under `reference_compat` (which keeps the full
    form). Shapes are read without their feature width."""
    batch, frames = 3, 7
    model = TransformerLSTM(CONFIG, torch.Generator().manual_seed(0), reference_compat=compat)
    seen = []
    hooks = [module.register_forward_hook(
                 lambda m, args, out: seen.append(tuple(args[0].shape[:-1])))
             for layer in model.encoder for module in (layer.attn.out, layer.ff2)]
    boxes = torch.rand(batch, frames, TOKENS, 5, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y = model.eval().forward_layers(boxes)
    for hook in hooks:
        hook.remove()
    assert y.shape == (batch, frames, 4)
    tokens = (TOKENS, batch * frames) if compat else (batch * frames, TOKENS)
    rows = tokens if compat else (batch * frames,)
    assert seen == [tokens, tokens, rows, rows]
