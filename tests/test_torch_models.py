"""The port's reasoning models against the JAX package's, on the CPU: the
five architectures beside OPNet (`baseline_lstm`, `non_linear_lstm`,
`transformer_lstm` in both its semantics, `opnet_lstm_mlp`, `opnet_moe`),
their parts (the stacked LSTM, the encoder layer, the MoE head and its
balance term), one train step each, the registry's specs, the weight bridge
with lists, `.pth` loading, the fused-kernel rule, and every learned name
through the CLI.

Inputs come from a numpy seed; parameters from the JAX init, crossed through
`models/convert.py`. On the CPU the JAX functions run their `lax.scan` path
and the port its plain step loops. Tolerances, with their reasons:
- forwards: atol 1e-5 (float32, the same products with sums in another
  order, over T <= 24 steps);
- one train step: metrics atol 1e-6; gradients rtol 1e-4, atol 1e-6; the
  updated params atol 1e-5 where |g| >= 1e-7 and, everywhere, atol 1e-7 to
  Adam's step taken from the port's own gradient (Adam's first step
  magnifies a tiny gradient's rounding; `tests/test_torch_train.py` says
  why). `transformer_lstm` is held without dropout on both sides: JAX's
  train step draws its dropout from its own generator, so the test takes
  `jax.grad` of JAX's `_forward(..., deterministic=True)` and Adam itself.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from objectpermanence_tpu.config import load_model_config as jax_load_model_config
from objectpermanence_tpu.infer.reasoning import fused_opnet_eligible as jax_fused_eligible
from objectpermanence_tpu.models import reasoning as jax_reasoning
from objectpermanence_tpu.models.convert_reasoning import convert_reference_state_dict
from objectpermanence_tpu.models.registry import INFERENCE_SUPPORTED_MODELS as JAX_NAMES
from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
from objectpermanence_tpu.ops import attention as jax_attention
from objectpermanence_tpu.ops.lstm import stacked_lstm_apply, stacked_lstm_init
from objectpermanence_tpu.parallel.expert import (
    moe_balance_loss as jax_moe_balance_loss, moe_head_apply, moe_head_init,
)
from objectpermanence_tpu.train import losses as jax_losses
from objectpermanence_tpu.train.loop import _forward as jax_forward
from objectpermanence_tpu.train.loop import make_optimizer as jax_make_optimizer
from objectpermanence_tpu.train.loop import make_train_step as jax_make_train_step
from objectpermanence_tpu_torch.__main__ import main as port_main
from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
from objectpermanence_tpu_torch.infer.reasoning import fused_opnet_eligible
from objectpermanence_tpu_torch.models.convert import params_from_jax, params_to_jax
from objectpermanence_tpu_torch.models.moe import MoEHead, moe_balance_loss
from objectpermanence_tpu_torch.models.registry import (
    INFERENCE_SUPPORTED_MODELS, TRAINING_SUPPORTED_MODELS, get_model_spec, init_model,
)
from objectpermanence_tpu_torch.ops.attention import EncoderLayer, dropout
from objectpermanence_tpu_torch.ops.lstm import StackedLSTM
from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step
from objectpermanence_tpu_torch.utils.checkpoint import trained_params
from torch_lane import one_torch_thread  # noqa: F401

B, T = 4, 24
CONFIGS = {
    "baseline_lstm": {"videos_hidden_dim": 16},
    "non_linear_lstm": {"boxes_features_dim": 8, "videos_hidden_dim": 16},
    "transformer_lstm": {"boxes_features_dim": 8, "num_attention_heads": 2,
                         "num_attention_layers": 2, "num_lstm_layers": 2, "lstm_hidden_dim": 16},
    "opnet": {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
              "videos_hidden_dim": 24},
    "opnet_lstm_mlp": {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
                       "videos_hidden_dim": 24},
    "opnet_moe": {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
                  "videos_hidden_dim": 24, "num_experts": 4, "expert_hidden": 8},
}
INITS = {"baseline_lstm": jax_reasoning.baseline_lstm_init,
         "non_linear_lstm": jax_reasoning.non_linear_lstm_init,
         "transformer_lstm": jax_reasoning.transformer_lstm_init,
         "opnet": jax_reasoning.opnet_init,
         "opnet_lstm_mlp": jax_reasoning.opnet_lstm_mlp_init,
         "opnet_moe": jax_reasoning.opnet_moe_init}
COMPAT = {"reference_compat": True}


def _base(name):
    if name == "opnet_att_ce":
        return "opnet"
    return name[:-len("_no_labels")] if name.endswith("_no_labels") else name


def _config(name, compat=False):
    config = dict(CONFIGS[_base(name)])
    return {**config, **COMPAT} if compat else config


def _params(name, seed=1):
    base = _base(name)
    return jax.device_get(INITS[base](jax.random.PRNGKey(seed), CONFIGS[base]))


def _boxes(feat, seed=2, batch=B, frames=T):
    return np.random.RandomState(seed).rand(batch, frames, 15, feat).astype(np.float32)


def _port(name, params, compat=False):
    """The port's model for `name` on the CPU with JAX's parameters."""
    spec = get_model_spec(name, _config(name, compat))
    model = spec.build(_config(name, compat))
    model.load_state_dict(params_from_jax(params))
    return spec, model.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


# --- forwards ------------------------------------------------------------

FORWARD_CASES = [("baseline_lstm", False), ("non_linear_lstm", False),
                 ("transformer_lstm", False), ("transformer_lstm", True),
                 ("opnet_lstm_mlp", False), ("opnet_moe", False)]


@pytest.mark.parametrize("name,compat", FORWARD_CASES,
                         ids=[n + ("_reference_compat" if c else "") for n, c in FORWARD_CASES])
def test_forward_matches_jax(name, compat):
    params = _params(name)
    jax_spec = jax_get_model_spec(name, _config(name, compat))
    spec, model = _port(name, params, compat)
    boxes = _boxes(spec.feature_width)
    want = jax_spec.apply(params, boxes)
    with torch.no_grad():
        got = model.forward_layers(_t(boxes))
    if spec.double_output:
        (want, want_logits), (got, got_logits) = want, got
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=0,
                                   atol=1e-5)
    assert got.shape == (B, T, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_transformer_semantics_differ():
    """The two semantics are different functions: reference_compat mixes
    the videos of a batch, the per-frame default does not."""
    params = _params("transformer_lstm")
    boxes = _t(_boxes(5))
    _, per_frame = _port("transformer_lstm", params)
    _, compat = _port("transformer_lstm", params, compat=True)
    with torch.no_grad():
        a, b = per_frame.forward_layers(boxes), compat.forward_layers(boxes)
        alone = compat.forward_layers(boxes[:1])
        alone_frame = per_frame.forward_layers(boxes[:1])
    assert (a - b).abs().max() > 1e-4
    assert (alone - b[:1]).abs().max() > 1e-6
    torch.testing.assert_close(alone_frame, a[:1], rtol=0, atol=1e-6)


def test_stacked_lstm_matches_jax():
    params = jax.device_get(stacked_lstm_init(jax.random.PRNGKey(4), 12, 16, 3))
    x = np.random.RandomState(5).rand(B, T, 12).astype(np.float32)
    model = StackedLSTM(12, 16, 3)
    model.load_state_dict(params_from_jax(params))
    assert [k for k in model.state_dict()] == [f"{i}.{w}" for i in range(3)
                                               for w in ("w_ih", "w_hh")]
    with torch.no_grad():
        got = model(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(stacked_lstm_apply(params, x)),
                               rtol=0, atol=1e-5)


def test_encoder_layer_matches_jax():
    params = jax.device_get(jax_attention.encoder_layer_init(jax.random.PRNGKey(6), 8, 2))
    x = np.random.RandomState(7).randn(6, 15, 8).astype(np.float32)
    layer = EncoderLayer(8, 2)
    layer.load_state_dict(params_from_jax(params))
    want = jax_attention.encoder_layer_apply(params, x, deterministic=True)
    with torch.no_grad():
        got = layer.eval()(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "token_weight"])
def test_moe_head_and_balance_loss_match_jax(weighted):
    params = jax.device_get(moe_head_init(jax.random.PRNGKey(8), 12, 4, num_experts=4,
                                          expert_hidden=8))
    h = np.random.RandomState(9).randn(B, T, 12).astype(np.float32)
    weights = np.array([1, 1, 0, 1], np.float32) if weighted else None
    head = MoEHead(12, 4, 4, 8)
    head.load_state_dict(params_from_jax(params))

    def jax_fn(p):
        out, probs = moe_head_apply(p, h, return_probs=True)
        return jax_moe_balance_loss(probs, token_weight=weights), out

    (want_loss, want_out), want_grads = jax.value_and_grad(jax_fn, has_aux=True)(params)
    out, probs = head(_t(h), return_probs=True)
    loss = moe_balance_loss(probs, None if weights is None else _t(weights))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0, atol=1e-6)
    want_grads = params_from_jax(want_grads)
    for key, param in head.named_parameters():
        grad = torch.zeros_like(param) if param.grad is None else param.grad
        np.testing.assert_allclose(grad.numpy(), want_grads[key].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_moe_argmax_tie_goes_to_first_expert():
    head = MoEHead(3, 4, 4, 8)
    with torch.no_grad():
        head.router.zero_()     # every expert equally likely
    probs = head(torch.ones(2, 3), return_probs=True)[1]
    onehot = jax.nn.one_hot(jnp.argmax(jnp.asarray(probs.detach().numpy()), -1), 4)
    assert torch.equal(torch.argmax(probs, -1), torch.zeros(2, dtype=torch.long))
    np.testing.assert_array_equal(np.asarray(onehot)[:, 0], [1, 1])
    np.testing.assert_allclose(moe_balance_loss(probs).item(),
                               float(jax_moe_balance_loss(jnp.asarray(probs.detach().numpy()))),
                               rtol=0, atol=1e-7)


# --- one train step --------------------------------------------------------

def _batch(feat, seed, ragged):
    """One batch as the loops gather it: a ragged one repeats its last real
    row into the padding, which carries weight 0."""
    rng = np.random.RandomState(seed)
    real = 3 if ragged else B
    rows = np.concatenate([np.arange(real), np.full(B - real, real - 1)])
    boxes = rng.rand(B, T, 15, feat).astype(np.float32)[rows]
    labels = rng.rand(B, T, 4).astype(np.float32)[rows]
    mask = (rng.rand(B, T, 4) > 0.5)[rows]
    tracks = rng.randint(0, 15, (B, T)).astype(np.int32)[rows]
    weights = (np.arange(B) < real).astype(np.float32)
    return boxes, labels, mask, tracks, weights


@functools.lru_cache(maxsize=None)
def _jax_train_step(name):
    spec = jax_get_model_spec(name, _config(name))
    optimizer = jax_make_optimizer(1e-3)
    return spec, optimizer, jax_make_train_step(spec, optimizer)


def _check_step(model, params, metrics, want_metrics, want_grads, want_new):
    assert sorted(metrics) == sorted(want_metrics)
    for key in metrics:
        np.testing.assert_allclose(metrics[key].item(), float(want_metrics[key]), rtol=0,
                                   atol=1e-6, err_msg=key)
    want_grads, want_new, old = (params_from_jax(want_grads), params_from_jax(want_new),
                                 params_from_jax(params))
    assert sorted(k for k, _ in model.named_parameters()) == sorted(want_new)
    for key, param in model.named_parameters():
        grad = param.grad.numpy()
        np.testing.assert_allclose(grad, want_grads[key].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
        new = param.detach().numpy()
        adam_step = old[key].numpy() - 1e-3 * grad / (np.abs(grad) + 1e-8)
        np.testing.assert_allclose(new, adam_step, rtol=0, atol=1e-7, err_msg=key)
        conditioned = np.abs(grad) >= 1e-7
        np.testing.assert_allclose(new[conditioned], want_new[key].numpy()[conditioned], rtol=0,
                                   atol=1e-5, err_msg=key)


STEP_CASES = [("baseline_lstm", False), ("baseline_lstm_no_labels", True),
              ("non_linear_lstm", False), ("non_linear_lstm_no_labels", True),
              ("opnet_lstm_mlp", False), ("opnet_lstm_mlp_no_labels", True),
              ("opnet_moe", False), ("opnet_moe", True)]


@pytest.mark.parametrize("name,ragged", STEP_CASES,
                         ids=[n + ("_ragged" if r else "") for n, r in STEP_CASES])
def test_train_step_matches_jax(name, ragged):
    params = _params(name, seed=3)
    jax_spec, optimizer, jax_step = _jax_train_step(name)
    boxes, labels, mask, tracks, weights = _batch(jax_spec.feature_width, 4, ragged)
    jax_params, jax_state, jax_metrics = jax_step(
        jax.tree.map(jnp.array, params), optimizer.init(params), boxes, labels, mask,
        jax.random.PRNGKey(5), jnp.asarray(weights), jnp.asarray(tracks))

    spec, model = _port(name, params)
    assert spec.aux_loss_weight == jax_spec.aux_loss_weight
    model.train()
    metrics = make_train_step(spec, make_optimizer(model.parameters(), 1e-3))(
        model, _t(boxes), _t(labels), _t(mask), _t(weights), _t(tracks))
    # after one Adam step the first moment is (1 - 0.9) * grad
    want_grads = jax.tree.map(lambda m: m / 0.1, jax.device_get(jax_state.inner_state[0].mu))
    _check_step(model, params, metrics, jax_metrics, want_grads, jax.device_get(jax_params))


@pytest.mark.parametrize("compat", [False, True], ids=["per_frame", "reference_compat"])
def test_transformer_train_step_matches_jax_grad(compat):
    name = "transformer_lstm_no_labels"
    params = _params(name, seed=6)
    jax_spec = jax_get_model_spec(name, _config(name, compat))
    boxes, labels, mask, tracks, weights = _batch(5, 7, ragged=True)

    def loss_fn(p):
        out = jax_forward(jax_spec, p, boxes, True, None)
        return jax_losses.total_loss(out, labels, mask, True, sample_weight=weights)

    (_, want_metrics), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    optimizer = optax.adam(1e-3)
    updates, _ = optimizer.update(want_grads, optimizer.init(params), params)
    want_new = optax.apply_updates(params, updates)

    spec, model = _port(name, params, compat)      # eval mode: no dropout
    metrics = make_train_step(spec, make_optimizer(model.parameters(), 1e-3))(
        model, _t(boxes), _t(labels), _t(mask), _t(weights), _t(tracks))
    _check_step(model, params, metrics, want_metrics, jax.device_get(want_grads),
                jax.device_get(want_new))


def test_dropout_zeroes_a_tenth_and_scales_the_rest():
    x = torch.ones(200_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    zeroed = (y == 0).float().mean().item()
    assert abs(zeroed - 0.1) < 0.005, zeroed
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert torch.equal(y, dropout(x, 0.1, torch.Generator().manual_seed(0)))


def test_train_mode_runs_dropout_from_the_generator():
    name = "transformer_lstm"
    _, model = _port(name, _params(name))
    boxes = _t(_boxes(5))
    with torch.no_grad():
        plain = model.forward_layers(boxes)
        model.train()
        a = model.forward_layers(boxes, torch.Generator().manual_seed(3))
        b = model.forward_layers(boxes, torch.Generator().manual_seed(3))
        c = model.forward_layers(boxes, torch.Generator().manual_seed(4))
        model.eval()
        again = model.forward_layers(boxes, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (a - plain).abs().max() > 1e-4
    assert torch.equal(again, plain)


# --- registry, bridge, .pth ------------------------------------------------

LEARNED = [n for n in JAX_NAMES if n not in ("detector_tracker", "detector_heuristic")]


@pytest.mark.parametrize("name", LEARNED)
def test_registry_spec_matches_jax(name):
    assert INFERENCE_SUPPORTED_MODELS == JAX_NAMES and TRAINING_SUPPORTED_MODELS == LEARNED
    for config in (None, jax_load_model_config(name), {"moe_balance_weight": 0.3}):
        ours, theirs = get_model_spec(name, config), jax_get_model_spec(name, config)
        for field in ("feature_width", "double_output", "no_labels", "aux_loss_weight",
                      "att_ce_weight"):
            assert getattr(ours, field) == getattr(theirs, field), (field, config)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bridge_round_trip_with_lists(name):
    params = _params(name)
    state = params_from_jax(params)
    model = get_model_spec(name).build(CONFIGS[name])
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in state.items()}
    back = params_to_jax(state)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


class _RefLSTMModel(nn.Module):
    """A module with the reference's layer names (`baselines/learned_models.py`)."""

    def __init__(self, name, config):
        super().__init__()
        base = _base(name)
        if base in ("opnet", "opnet_lstm_mlp"):
            hidden, vid = config["object_to_track_hidden_dim"], config["videos_hidden_dim"]
            self.object_to_track_LSTM = nn.LSTM(90, hidden, bias=False, batch_first=True)
            self.object_to_track_prediction = nn.Linear(hidden, 15, bias=False)
            if base == "opnet":
                self.video_LSTM = nn.LSTM(6, vid, bias=False, batch_first=True)
            else:
                self.hidden_layer = nn.Linear(6, vid, bias=False)
            self.prediction_layer = nn.Linear(vid, 4, bias=False)
        elif base == "baseline_lstm":
            self.video_LSTM = nn.LSTM(75, config["videos_hidden_dim"], bias=False)
            self.predictions_layer = nn.Linear(config["videos_hidden_dim"], 4, bias=False)
        else:
            feat = config["boxes_features_dim"]
            self.boxes_linear = nn.Linear(5, feat, bias=False)
            if base == "transformer_lstm":
                self.attention_encoder = nn.TransformerEncoder(
                    nn.TransformerEncoderLayer(feat, config["num_attention_heads"]),
                    config["num_attention_layers"], enable_nested_tensor=False)
                hidden, layers, width = (config["lstm_hidden_dim"], config["num_lstm_layers"],
                                         feat)
            else:
                hidden, layers, width = config["videos_hidden_dim"], 2, 15 * feat
            self.video_LSTM = nn.LSTM(width, hidden, num_layers=layers, bias=False)
            self.predictions_layer = nn.Linear(hidden, 4, bias=False)


@pytest.mark.parametrize("name", ["opnet", "opnet_lstm_mlp_no_labels", "baseline_lstm",
                                  "non_linear_lstm", "transformer_lstm"])
def test_pth_loading_matches_jax_converter(name, tmp_path):
    torch.manual_seed(0)
    reference = _RefLSTMModel(name, CONFIGS[_base(name)])
    for param in reference.parameters():    # biases and norms away from their inits too
        nn.init.uniform_(param, -0.5, 0.5)
    torch.save(reference.state_dict(), tmp_path / "ref.pth")
    want = convert_reference_state_dict(name, reference.state_dict(), _params(name))
    _, model = init_model(name, CONFIGS[_base(name)], checkpoint_path=str(tmp_path / "ref.pth"),
                          device="cpu")
    want = params_from_jax(jax.device_get(want))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "moe"])
def test_pth_loading_fails_on_a_mismatch(fault, tmp_path):
    name = "non_linear_lstm"
    state = _RefLSTMModel(name, CONFIGS[name]).state_dict()
    if fault == "missing":
        del state["video_LSTM.weight_hh_l1"]
    elif fault == "extra":
        state["video_LSTM.weight_ih_l2"] = state["video_LSTM.weight_ih_l1"]
    elif fault == "shape":
        state["boxes_linear.weight"] = torch.zeros(8, 6)
    torch.save(state, tmp_path / "ref.pth")
    with pytest.raises((KeyError, ValueError)):
        init_model("opnet_moe" if fault == "moe" else name,
                   CONFIGS["opnet_moe" if fault == "moe" else name],
                   checkpoint_path=str(tmp_path / "ref.pth"), device="cpu")


@pytest.mark.parametrize("name", JAX_NAMES)
def test_fused_opnet_eligible_matches_jax(name):
    assert fused_opnet_eligible(name) == jax_fused_eligible(name)


# --- every learned name through the CLI -------------------------------------

@pytest.fixture(scope="module")
def fixture_splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("models_fixture")
    train = write_fixture_dataset(root / "train", num_videos=6, seed=2, num_frames=T)
    dev = write_fixture_dataset(root / "dev", num_videos=4, seed=3, num_frames=T)
    return train, dev


@pytest.mark.parametrize("name", LEARNED)
def test_cli_training_then_inference_on_cpu(name, fixture_splits, tmp_path):
    (train_pred, train_labels, train_cont), (dev_pred, dev_labels, dev_cont) = fixture_splits
    (tmp_path / "model.json").write_text(json.dumps(_config(name)))
    (tmp_path / "training.json").write_text(json.dumps({
        "train_sample_dir": str(train_pred), "train_labels_dir": str(train_labels),
        "train_containment_file": str(train_cont), "dev_sample_dir": str(dev_pred),
        "dev_labels_dir": str(dev_labels), "dev_containment_file": str(dev_cont),
        "device": "cpu", "num_epochs": 1, "batch_size": 4, "print_step": 1,
        "checkpoints_path": str(tmp_path / "ckpt"),
        "metrics_file": str(tmp_path / "metrics.jsonl")}))
    assert port_main(["training", "--model_type", name, "--model_config",
                      str(tmp_path / "model.json"), "--training_config",
                      str(tmp_path / "training.json")]) == 0
    # the best-dev tree, or the last epoch's params where the dev mIoU was NaN
    model_path, _ = trained_params(tmp_path / "ckpt" / name, tmp_path / "metrics.jsonl")
    (tmp_path / "inference.json").write_text(json.dumps({
        "sample_dir": str(dev_pred), "labels_dir": str(dev_labels), "device": "cpu",
        "batch_size": 3, "model_path": str(model_path)}))
    assert port_main(["inference", "--model_type", name, "--results_dir", str(tmp_path / "out"),
                      "--inference_config", str(tmp_path / "inference.json"),
                      "--model_config", str(tmp_path / "model.json")]) == 0
    files = sorted((tmp_path / "out").glob("*_bb.json"))
    assert len(files) == 4
    boxes = np.array([json.loads(f.read_text()) for f in files])
    assert boxes.shape == (4, T, 4) and boxes.dtype.kind == "i"
