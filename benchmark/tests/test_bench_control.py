"""The control fails the committed limits: the reference computed in TF32
(the nearest precision below the configurations' float32), put in the
program's place, at the published widths and a batch the CPU can hold.
On the card the same readings at the cells' own sizes come from
`benchmark/calibrate.py`."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.kinds import serve, train


def _ctx(manifest, cell, mix_changes):
    ctx = harness.context(manifest, cell, 2**32 + 9, torch.device("cpu"))
    ctx.mix = {**ctx.mix, **mix_changes}
    ctx.log = lambda text: None
    return ctx


def _weights(ctx):
    from benchmark.models import make_weights
    return make_weights(ctx.adapter.leaves(ctx.config), 5, ctx.device)


@pytest.mark.parametrize("cell,videos", [("opnet.serve_b512", 96),
                                         ("transformer_lstm.serve_b512", 8)])
def test_tf32_fails_a_serve_cell(manifest, cell, videos):
    ctx = _ctx(manifest, cell, {"reference_rows": videos})
    boxes = ctx.cache["boxes"][np.arange(videos) % 50, :, :, :ctx.adapter.FEATURES]
    state = {"pool": [torch.from_numpy(np.ascontiguousarray(boxes))], "weights": _weights(ctx),
             "kept": [(0, None)]}
    ok, compared = harness.judge(ctx, serve.numbers(ctx, state, precision="tf32"))
    assert not ok, compared


@pytest.mark.parametrize("cell,videos", [("transformer_lstm.train_b16", 2)])
def test_tf32_fails_a_train_cell(manifest, cell, videos):
    ctx = _ctx(manifest, cell, {"videos": videos})
    rows = np.random.default_rng(3).permutation(50)[:3 * videos].reshape(3, videos)
    feats = ctx.adapter.FEATURES
    state = {"weights": _weights(ctx), "first": list(rows),
             "boxes": np.ascontiguousarray(ctx.cache["boxes"][..., :feats]),
             "labels": ctx.cache["labels"]}
    numbers = train.numbers(ctx, state, precision="tf32")
    ok, compared = harness.judge(ctx, numbers)
    assert not ok, compared
