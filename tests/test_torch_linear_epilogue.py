"""`ops/linear.py::linear_bias`, the products that add their bias (and
ff1's ReLU) in the epilogue, against the `matmul` + `b` (+ `relu`)
composition they replace, on the CPU: outputs within float32 round-off
(rtol 1e-5, atol 1e-5 x max(1, max |composition's|)); strided rows read in
place. Under autograd the composition itself runs, bit for bit.
`linear_bias.launches` counts a fused product per call, 8 a
`transformer_lstm` eval forward (QKV, out, ff1, ff2 in each of its 2
encoder layers) and none in a train step.
"""

import pytest
import torch

from objectpermanence_tpu_torch.models.reasoning import TransformerLSTM
from objectpermanence_tpu_torch.ops import attention, linear
from objectpermanence_tpu_torch.ops.linear import Linear, linear_bias
from torch_lane import one_torch_thread  # noqa: F401


def _composed(x, w, b, relu=False):
    y = torch.matmul(x, w) + b
    return torch.relu(y) if relu else y


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, want.abs().max().item()))


def _operands(shape, out_dim, seed=0):
    draw = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=draw)
    w = torch.randn(shape[-1], out_dim, generator=draw) / shape[-1] ** 0.5
    b = torch.randn(out_dim, generator=draw)
    return x, w, b


# (input shape, out): an encoder's (sequences, tokens, features) rows, 2-D
# rows, and a wide output
SHAPES = [((6, 15, 32), 48), ((37, 64), 16), ((40, 24), 128)]


@pytest.mark.parametrize("relu", [False, True], ids=["bias", "bias_relu"])
@pytest.mark.parametrize("shape,out_dim", SHAPES, ids=["tokens", "rows", "wide"])
def test_linear_bias_matches_the_composition(shape, out_dim, relu):
    x, w, b = _operands(shape, out_dim)
    before = linear_bias.launches
    with torch.no_grad():
        got, want = linear_bias(x, w, b, relu), _composed(x, w, b, relu)
    assert linear_bias.launches == before + 1
    assert got.shape == want.shape
    _close(got, want)
    if relu:  # the ReLU acted
        assert (want == 0).any() and (got >= 0).all()


@pytest.mark.parametrize("relu", [False, True], ids=["bias", "bias_relu"])
@pytest.mark.parametrize("shape,out_dim", SHAPES, ids=["tokens", "rows", "wide"])
def test_under_autograd_the_ops_stay_separate(shape, out_dim, relu):
    """Training differentiates the composition itself: the output and the
    gradients of x, w and b bit for bit, and no fused product counted."""
    x, w, b = _operands(shape, out_dim)
    before = linear_bias.launches
    runs = []
    for fn in (linear_bias, _composed):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        y = fn(*leaves, relu)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        runs.append([y.detach()] + [t.grad for t in leaves])
    assert linear_bias.launches == before
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_strided_rows_are_read_in_place():
    """The one-slot layer's out-projection reads `ctx[:, slot]`, a strided
    view: the product takes it as it is."""
    x, w, b = _operands((10, 15, 16), 16)
    rows = x[:, 3]
    with torch.no_grad():
        _close(linear_bias(rows, w, b), _composed(rows, w, b, False))


def test_bias_free_linear_is_a_plain_product():
    layer = Linear(6, 4, torch.Generator().manual_seed(0))
    x = torch.randn(5, 6)
    before = linear_bias.launches
    assert torch.equal(layer(x), x @ layer.w)
    assert linear_bias.launches == before


CONFIG = {"boxes_features_dim": 16, "num_attention_heads": 2, "num_attention_layers": 2,
          "num_lstm_layers": 2, "lstm_hidden_dim": 12}


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("compat", [False, True], ids=["per_frame", "reference_compat"])
def test_counter_reads_8_a_transformer_lstm_forward(mode, compat):
    """8 fused products an eval forward; a train forward, under autograd,
    runs none."""
    model = TransformerLSTM(CONFIG, torch.Generator().manual_seed(0), reference_compat=compat)
    model.train(mode == "train")
    boxes = torch.rand(2, 5, 15, 5, generator=torch.Generator().manual_seed(1))
    before = linear_bias.launches
    with torch.set_grad_enabled(mode == "train"):
        model.forward_layers(boxes, torch.Generator().manual_seed(2))
    assert linear_bias.launches - before == (8 if mode == "eval" else 0)


@pytest.mark.parametrize("compat", [False, True], ids=["per_frame", "reference_compat"])
def test_train_forward_and_backward_are_the_composition(compat, monkeypatch):
    """A transformer_lstm train forward, dropout drawn from the same seed,
    and its backward: the outputs and every parameter's gradient equal the
    model's run on the composition, bit for bit."""
    runs = []
    for fused in (True, False):
        with monkeypatch.context() as patch:
            if not fused:
                patch.setattr(attention, "linear_bias", _composed)
                patch.setattr(linear, "linear_bias", _composed)
            model = TransformerLSTM(CONFIG, torch.Generator().manual_seed(0),
                                    reference_compat=compat).train()
            boxes = torch.rand(2, 5, 15, 5, generator=torch.Generator().manual_seed(1))
            y = model.forward_layers(boxes, torch.Generator().manual_seed(2))
            (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
            runs.append([y.detach()] + [p.grad for p in model.parameters()])
    assert len(runs[0]) == len(runs[1])
    for got, want in zip(*runs):
        assert got is not None and want is not None
        assert torch.equal(got, want)
