"""Each plain reference against the port, on the same weights and inputs,
at a small size on the CPU (where the port runs its plain paths)."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.models import make_weights, port_model
from benchmark.reference.common import l1_loss, to_pixels

from conftest import TINY_CONFIGS

CELLS = {"opnet": "opnet.serve_b512", "transformer_lstm": "transformer_lstm.serve_b512"}


def _inputs(ctx, videos=3, frames=20):
    boxes = ctx.cache["boxes"][:videos, :frames, :, :ctx.adapter.FEATURES]
    labels = ctx.cache["labels"][:videos, :frames]
    return torch.from_numpy(np.ascontiguousarray(boxes)), torch.from_numpy(labels)


def _ctx(manifest, config):
    return harness.context(manifest, CELLS[config], 5, torch.device("cpu"),
                           TINY_CONFIGS[config])


@pytest.mark.parametrize("config", sorted(CELLS))
def test_forward_matches_the_port(manifest, config):
    ctx = _ctx(manifest, config)
    weights = make_weights(ctx.adapter.leaves(ctx.config), 11, ctx.device)
    _, model = port_model(ctx.adapter.PORT_NAME, ctx.config, weights, ctx.device, train=False)
    boxes, _ = _inputs(ctx)
    with torch.no_grad():
        ours = ctx.reference.forward(weights, boxes, ctx.config)
        port = model.forward_layers(boxes)
        port = port[0] if isinstance(port, tuple) else port
    torch.testing.assert_close(ours, port, rtol=1e-5, atol=1e-6)
    assert torch.equal(to_pixels(ours), to_pixels(port)) or \
        (to_pixels(ours).int() - to_pixels(port).int()).abs().max() <= 1


@pytest.mark.parametrize("config", sorted(CELLS))
def test_gradient_matches_the_port_with_dropout(manifest, config):
    ctx = _ctx(manifest, config)
    weights = make_weights(ctx.adapter.leaves(ctx.config), 12, ctx.device)
    _, model = port_model(ctx.adapter.PORT_NAME, ctx.config, weights, ctx.device, train=True)
    boxes, labels = _inputs(ctx)
    port = model.forward_layers(boxes, torch.Generator().manual_seed(3))
    l1_loss(port[0] if isinstance(port, tuple) else port, labels).backward()
    params = {k: w.clone().requires_grad_(True) for k, w in weights.items()}
    loss = l1_loss(ctx.reference.forward(params, boxes, ctx.config,
                                         generator=torch.Generator().manual_seed(3),
                                         train=True), labels)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for name, p in model.named_parameters():
        torch.testing.assert_close(grads[name], p.grad, rtol=1e-4, atol=1e-7)


def test_weights_are_drawn_once_from_the_seed():
    leaves = [("a", (3, 4), ("uniform", 0.5)), ("b", (2,), ("ones",)),
              ("c", (5,), ("uniform", 2.0)), ("d", (2, 2), ("zeros",))]
    one = make_weights(leaves, 99, torch.device("cpu"))
    two = make_weights(leaves, 99, torch.device("cpu"))
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert one["a"].abs().max() <= 0.5 and one["c"].abs().max() <= 2.0
    assert torch.equal(one["b"], torch.ones(2)) and torch.equal(one["d"], torch.zeros(2, 2))
    assert not torch.equal(one["a"], make_weights(leaves, 100, torch.device("cpu"))["a"])


def test_only_leaves_at_round_off_are_left_out(manifest, monkeypatch):
    from benchmark.kinds import train

    from conftest import TINY_MIXES

    ctx = harness.context(manifest, "transformer_lstm.train_b16", 6, torch.device("cpu"),
                          TINY_CONFIGS["transformer_lstm"], TINY_MIXES["train"])
    rows = np.random.default_rng(4).permutation(50)[:12].reshape(3, 4)
    state = {"weights": make_weights(ctx.adapter.leaves(ctx.config), 13, ctx.device),
             "first": list(rows), "labels": ctx.cache["labels"][:, :12],
             "boxes": np.ascontiguousarray(ctx.cache["boxes"][:, :12, :, :ctx.adapter.FEATURES])}
    grad = train.reference_run(ctx, state)[1]
    assert train.roundoff_leaves(ctx, state, grad) == []
    # every leaf counted small: float32 computes each to many digits, so
    # none is round-off, however small it is beside the median leaf
    monkeypatch.setattr(train, "SMALL_LEAF", 1e9)
    assert train.roundoff_leaves(ctx, state, grad) == []
    noise = dict(grad, **{"box_head.w": 1e-9 * torch.randn_like(grad["box_head.w"])})
    assert train.roundoff_leaves(ctx, state, noise) == ["box_head.w"]
