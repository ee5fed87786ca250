"""The port's training path against the JAX package's, on the CPU: losses,
the plateau scheduler, one train step and one eval step, a short fixture
run of `training_main`, resume, and the CLI.

Inputs come from a numpy seed; parameters come from the JAX init and cross
through `models/convert.py`. On the CPU the JAX steps take the `lax.scan`
path and the port's the plain step loops. Tolerances, with their reasons:
- losses and their gradients: atol 1e-6 (float32, sums in another order);
- one train step: loss and metrics atol 1e-6; gradients rtol 1e-4, atol
  1e-6; updated params atol 1e-5. Adam's first step is lr g / (|g| + eps),
  which magnifies a gradient's rounding by lr eps / (|g| + eps)^2, over 1e4
  where |g| < 1e-7 (a 2e-10 difference in a gradient of 3e-9 moves its
  param by 1.4e-5). So every param is held to that step taken from the
  port's own gradient (atol 1e-7), and to the JAX params where |g| >= 1e-7;
- a fixture run: losses rtol 1e-4; mean IoUs atol 1e-3, since a box that
  lies within rounding of an integer pixel can flip one pixel.
JAX batch sizes are multiples of 8: its loop rounds the batch to the
8-device CPU mesh of `tests/conftest.py`.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectpermanence_tpu.data.ingest import ingest_directory as jax_ingest_directory
from objectpermanence_tpu.models.reasoning import opnet_init
from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
from objectpermanence_tpu.train import losses as jax_losses
from objectpermanence_tpu.train.loop import make_eval_step as jax_make_eval_step
from objectpermanence_tpu.train.loop import make_optimizer as jax_make_optimizer
from objectpermanence_tpu.train.loop import make_train_step as jax_make_train_step
from objectpermanence_tpu.train.loop import training_main as jax_training_main
from objectpermanence_tpu.train.plateau import ReduceLROnPlateau as JaxPlateau
from objectpermanence_tpu_torch.__main__ import main as port_main
from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
from objectpermanence_tpu_torch.data.ingest import ingest_directory
from objectpermanence_tpu_torch.models.convert import params_from_jax
from objectpermanence_tpu_torch.models.reasoning import OPNet
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.train import losses
from objectpermanence_tpu_torch.train.loop import (
    make_eval_step, make_optimizer, make_train_step, training_main,
)
from objectpermanence_tpu_torch.train.plateau import ReduceLROnPlateau
from objectpermanence_tpu_torch.utils.checkpoint import (
    latest_checkpoint, restore_train_state, save_train_state,
)
from torch_lane import one_torch_thread  # noqa: F401

NARROW = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
          "videos_hidden_dim": 24}
BATCH, FRAMES = 8, 20
# name, the att_ce_weight its model config carries (None: the registry's 1.0)
MODELS = [("opnet", None), ("opnet_no_labels", None), ("opnet_att_ce", 0.1),
          ("opnet_att_ce", None)]


def _batch(seed, ragged):
    """One batch as the loops gather it: a ragged one repeats its last real
    row into the padding, which carries weight 0."""
    rng = np.random.RandomState(seed)
    real = 5 if ragged else BATCH
    rows = np.concatenate([np.arange(real), np.full(BATCH - real, real - 1)])
    boxes = rng.rand(BATCH, FRAMES, 15, 6).astype(np.float32)[rows]
    labels = rng.rand(BATCH, FRAMES, 4).astype(np.float32)[rows]
    mask = (rng.rand(BATCH, FRAMES, 4) > 0.5)[rows]
    tracks = rng.randint(0, 15, (BATCH, FRAMES)).astype(np.int32)[rows]
    weights = (np.arange(BATCH) < real).astype(np.float32)
    return boxes, labels, mask, tracks, weights


def _port_model(params, config):
    model = OPNet(config)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return model


def _t(a):
    return torch.from_numpy(np.array(a))


# --- losses --------------------------------------------------------------

LOSS_CASES = {
    "l1": (lambda m, o, l, mask, tr, w: m.l1_pred_loss(o, l, sample_weight=w)),
    "l1_masked": (lambda m, o, l, mask, tr, w: m.l1_pred_loss(o, l, mask, sample_weight=w)),
    "consistency": (lambda m, o, l, mask, tr, w: m.consistency_loss(o, sample_weight=w)),
    "attention_ce": (lambda m, o, l, mask, tr, w: m.attention_ce_loss(l, tr, sample_weight=w)),
    "total": (lambda m, o, l, mask, tr, w: m.total_loss(o, l, mask, False, sample_weight=w)[0]),
    "total_no_labels": (lambda m, o, l, mask, tr, w: m.total_loss(o, l, mask, True,
                                                                  sample_weight=w)[0]),
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_losses_match_jax(case, weighted):
    rng = np.random.RandomState(0)
    output = rng.rand(4, 10, 4).astype(np.float32)
    if case == "attention_ce":
        output = rng.randn(4, 15, 10).astype(np.float32)  # logits (B, objects, T)
    labels = rng.rand(4, 10, 4).astype(np.float32)
    mask = (rng.rand(4, 10, 4) > 0.5).astype(np.float32)
    tracks = rng.randint(0, 15, (4, 10)).astype(np.int32)
    weights = np.array([1, 1, 1, 0], np.float32) if weighted else None
    fn = LOSS_CASES[case]
    if case == "attention_ce":  # the logits take the labels' place
        jax_fn = lambda o: fn(jax_losses, None, o, mask, tracks, weights)  # noqa: E731
        port_fn = lambda o: fn(losses, None, o, _t(mask), _t(tracks),  # noqa: E731
                               None if weights is None else _t(weights))
    else:
        jax_fn = lambda o: fn(jax_losses, o, labels, mask, tracks, weights)  # noqa: E731
        port_fn = lambda o: fn(losses, o, _t(labels), _t(mask), _t(tracks),  # noqa: E731
                               None if weights is None else _t(weights))
    want, want_grad = jax.value_and_grad(jax_fn)(output)
    out = torch.tensor(output, requires_grad=True)
    got = port_fn(out)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)


def test_consistency_gradient_finite_at_zero_deltas():
    output = np.tile(np.random.RandomState(1).rand(3, 1, 4).astype(np.float32), (1, 6, 1))
    out = torch.tensor(output, requires_grad=True)
    value = losses.consistency_loss(out)
    value.backward()
    want_grad = jax.grad(lambda o: jax_losses.consistency_loss(o))(output)
    assert torch.isfinite(out.grad).all()
    np.testing.assert_allclose(value.item(), 1e-6, rtol=1e-3)  # sqrt(eps)
    np.testing.assert_allclose(out.grad.numpy(), np.asarray(want_grad), atol=1e-6)


def test_plateau_matches_jax():
    metrics = [1.0, 0.9, 0.9, 0.95, 0.91, 0.9, 0.8, 0.8, 0.8, 0.8, 0.79995, 0.7]
    ours, theirs = ReduceLROnPlateau(lr=1e-3), JaxPlateau(lr=1e-3)
    trajectory = [(ours.step(m), theirs.step(m)) for m in metrics]
    assert [a for a, _ in trajectory] == [b for _, b in trajectory]
    assert trajectory[-1][0] < 1e-3  # it did reduce
    assert ours.state_dict() == theirs.state_dict()
    restored = ReduceLROnPlateau(lr=1.0)
    restored.load_state_dict(ours.state_dict())
    assert restored.state_dict() == ours.state_dict()


# --- one step ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_train_step(name, att_ce_weight):
    """JAX's spec, optimizer and jitted step, compiled once for the full and
    the ragged batch (same shapes)."""
    config = dict(NARROW) if att_ce_weight is None else {**NARROW, "att_ce_weight": att_ce_weight}
    spec = jax_get_model_spec(name, config)
    optimizer = jax_make_optimizer(1e-3)
    return spec, optimizer, jax_make_train_step(spec, optimizer)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("name,att_ce_weight", MODELS,
                         ids=["opnet", "opnet_no_labels", "opnet_att_ce_0.1", "opnet_att_ce_1.0"])
def test_train_step_matches_jax(name, att_ce_weight, ragged):
    config = dict(NARROW) if att_ce_weight is None else {**NARROW, "att_ce_weight": att_ce_weight}
    boxes, labels, mask, tracks, weights = _batch(1, ragged)
    params = jax.device_get(opnet_init(jax.random.PRNGKey(2), config))

    jax_spec, optimizer, jax_step = _jax_train_step(name, att_ce_weight)
    jax_params, jax_state, jax_metrics = jax_step(
        jax.tree.map(jnp.array, params), optimizer.init(params), boxes, labels, mask,
        jax.random.PRNGKey(3), jnp.asarray(weights), jnp.asarray(tracks))

    spec = get_model_spec(name, config)
    assert spec.att_ce_weight == jax_spec.att_ce_weight == (
        0.0 if name != "opnet_att_ce" else (att_ce_weight or 1.0))
    model = _port_model(params, config)
    torch_optimizer = make_optimizer(model.parameters(), 1e-3)
    metrics = make_train_step(spec, torch_optimizer)(
        model, _t(boxes), _t(labels), _t(mask), _t(weights), _t(tracks))

    assert sorted(metrics) == sorted(jax_metrics)
    for key in metrics:
        np.testing.assert_allclose(metrics[key].item(), float(jax_metrics[key]), rtol=0,
                                   atol=1e-6, err_msg=key)
    # after one Adam step the first moment is (1 - 0.9) * grad on both sides
    jax_grads = params_from_jax(jax.device_get(jax_state.inner_state[0].mu))
    jax_new = params_from_jax(jax.device_get(jax_params))
    old = params_from_jax(params)
    for key, param in model.named_parameters():
        grad = param.grad.numpy()
        np.testing.assert_allclose(grad, jax_grads[key].numpy() / 0.1, rtol=1e-4, atol=1e-6,
                                   err_msg=key)
        new = param.detach().numpy()
        adam_step = old[key].numpy() - 1e-3 * grad / (np.abs(grad) + 1e-8)
        np.testing.assert_allclose(new, adam_step, rtol=0, atol=1e-7, err_msg=key)
        conditioned = np.abs(grad) >= 1e-7
        np.testing.assert_allclose(new[conditioned], jax_new[key].numpy()[conditioned], rtol=0,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", ["opnet", "opnet_no_labels"])
def test_eval_step_matches_jax(name):
    boxes, labels, mask, _, _ = _batch(4, False)
    params = jax.device_get(opnet_init(jax.random.PRNGKey(5), NARROW))
    want = jax_make_eval_step(jax_get_model_spec(name))(params, boxes, labels, mask)
    model = _port_model(params, NARROW)
    got = make_eval_step(get_model_spec(name))(model, _t(boxes), _t(labels), _t(mask))
    for key in ("loss", "pred_loss", "consistency_loss"):
        np.testing.assert_allclose(got[0][key].item(), float(want[0][key]), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3 * FRAMES)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


# --- a short fixture run ----------------------------------------------------

@pytest.fixture(scope="module")
def fixture_splits(tmp_path_factory):
    root = tmp_path_factory.mktemp("splits")
    train = write_fixture_dataset(root / "train", num_videos=12, seed=2, num_frames=FRAMES)
    dev = write_fixture_dataset(root / "dev", num_videos=8, seed=3, num_frames=FRAMES)
    return train, dev


def _train_config(tmp_path, epochs, **extra):
    return {"batch_size": BATCH, "inference_batch_size": BATCH, "num_epochs": epochs,
            "print_step": 1, "learning_rate": 1e-3, "checkpoints_path": str(tmp_path / "ckpt"),
            "train_sample_dir": "x", "train_labels_dir": "x", "train_containment_file": "x",
            "dev_sample_dir": "x", "dev_labels_dir": "x", "dev_containment_file": "x",
            **extra}


def _saved_lines(text):
    return [line for line in text.splitlines() if line.startswith("Saved best model")]


@pytest.mark.parametrize("name", ["opnet", "opnet_no_labels", "opnet_att_ce"])
def test_training_main_matches_jax(name, fixture_splits, tmp_path, capsys):
    (train_pred, train_labels, train_cont), (dev_pred, dev_labels, dev_cont) = fixture_splits
    jax_train = jax_ingest_directory(train_pred, train_labels, 6, train_cont)
    jax_dev = jax_ingest_directory(dev_pred, dev_labels, 6, dev_cont)
    jax_spec = jax_get_model_spec(name)
    jax_result = jax_training_main(jax_spec, jax_train, jax_dev,
                                   _train_config(tmp_path / "jax", 2), NARROW)
    jax_saved = _saved_lines(capsys.readouterr().out)

    # the port starts from the JAX init: its spec builds the model from it
    params = opnet_init(jax.random.PRNGKey(0), NARROW)
    spec = dataclasses.replace(get_model_spec(name),
                               build=lambda config, generator: _port_model(params, config))
    train = ingest_directory(train_pred, train_labels, 6, train_cont)
    dev = ingest_directory(dev_pred, dev_labels, 6, dev_cont)
    result = training_main(spec, train, dev, _train_config(tmp_path / "port", 2, device="cpu"),
                           NARROW)
    saved = _saved_lines(capsys.readouterr().out)

    assert [h["epoch"] for h in result.history] == [h["epoch"] for h in jax_result.history]
    for ours, theirs in zip(result.history, jax_result.history):
        assert ours["learning_rate"] == pytest.approx(theirs["learning_rate"], rel=1e-6)
        for split in ("train", "dev"):
            np.testing.assert_allclose(ours[split]["loss"], theirs[split]["loss"], rtol=1e-4)
            for key in ("mean_iou", "containment_mean_iou"):
                np.testing.assert_allclose(ours[split][key], theirs[split][key], atol=1e-3)
    assert saved == jax_saved and saved
    assert len(list((tmp_path / "port" / "ckpt" / name).glob("*.npz"))) == len(
        {line.rsplit(" ", 1)[1] for line in saved})


def test_resume_continues_and_completes(fixture_splits, tmp_path):
    (train_pred, train_labels, train_cont), (dev_pred, dev_labels, dev_cont) = fixture_splits
    train = ingest_directory(train_pred, train_labels, 6, train_cont)
    dev = ingest_directory(dev_pred, dev_labels, 6, dev_cont)
    spec = get_model_spec("opnet")
    straight = training_main(spec, train, dev, _train_config(tmp_path / "a", 3, device="cpu"),
                             NARROW)

    first = training_main(spec, train, dev, _train_config(tmp_path / "b", 1, device="cpu"),
                          NARROW)
    assert [h["epoch"] for h in first.history] == [1]
    resumed = training_main(spec, train, dev, _train_config(tmp_path / "b", 3, device="cpu"),
                            NARROW, resume=True)
    assert [h["epoch"] for h in resumed.history] == [2, 3]
    assert resumed.best_dev_iou >= first.best_dev_iou
    # params, Adam's moments and step, the scheduler and the shuffle all
    # carry over: the resumed epochs are the uninterrupted run's
    for ours, theirs in zip(resumed.history, straight.history[1:]):
        for split in ("train", "dev"):
            np.testing.assert_allclose(ours[split]["loss"], theirs[split]["loss"], rtol=1e-6)
        assert ours["learning_rate"] == theirs["learning_rate"]

    done = training_main(spec, train, dev, _train_config(tmp_path / "b", 3, device="cpu"),
                         NARROW, resume=True)
    assert done.history == []


def test_train_state_round_trip(tmp_path):
    model = OPNet(NARROW, torch.Generator().manual_seed(0))
    optimizer = make_optimizer(model.parameters(), 1e-3)
    boxes, labels, mask, tracks, weights = _batch(6, False)
    make_train_step(get_model_spec("opnet"), optimizer)(model, _t(boxes), _t(labels), _t(mask),
                                                        _t(weights), _t(tracks))
    save_train_state(tmp_path / "resume" / "epoch_0001", model, optimizer, {"epoch": 1})
    clone = OPNet(NARROW, torch.Generator().manual_seed(1))
    clone_optimizer = make_optimizer(clone.parameters(), 1e-3)
    assert latest_checkpoint(tmp_path / "resume") == tmp_path / "resume" / "epoch_0001"
    assert restore_train_state(tmp_path / "resume" / "epoch_0001", clone, clone_optimizer) == {
        "epoch": 1}
    for (key, a), (_, b) in zip(model.named_parameters(), clone.named_parameters()):
        assert torch.equal(a, b), key
        for part in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(optimizer.state[a][part], clone_optimizer.state[b][part])
    assert latest_checkpoint(tmp_path / "missing") is None


def test_cli_training_then_inference_on_cpu(fixture_splits, tmp_path, capsys):
    (train_pred, train_labels, train_cont), (dev_pred, dev_labels, dev_cont) = fixture_splits
    training = {**_train_config(tmp_path, 1, device="cpu"),
                "train_sample_dir": str(train_pred), "train_labels_dir": str(train_labels),
                "train_containment_file": str(train_cont), "dev_sample_dir": str(dev_pred),
                "dev_labels_dir": str(dev_labels), "dev_containment_file": str(dev_cont),
                "metrics_file": str(tmp_path / "metrics.jsonl")}
    (tmp_path / "training.json").write_text(json.dumps(training))
    (tmp_path / "model.json").write_text(json.dumps(NARROW))
    argv = ["training", "--model_type", "opnet_no_labels", "--model_config",
            str(tmp_path / "model.json"), "--training_config", str(tmp_path / "training.json")]
    assert port_main(argv) == 0
    tree = tmp_path / "ckpt" / "opnet_no_labels"
    assert len(list(tree.glob("*.npz"))) == 1
    assert (tree / "resume" / "epoch_0001" / "state.npz").exists()
    assert json.loads((tree / "resume" / "epoch_0001" / "metadata.json").read_text())["epoch"] == 1
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 1

    assert port_main(argv + ["--resume"]) == 0  # complete: a no-op
    assert "Resumed from" in capsys.readouterr().out

    inference = {"sample_dir": str(dev_pred), "labels_dir": str(dev_labels),
                 "model_path": str(tree), "device": "cpu"}
    (tmp_path / "inference.json").write_text(json.dumps(inference))
    assert port_main(["inference", "--model_type", "opnet_no_labels", "--results_dir",
                      str(tmp_path / "R"), "--inference_config", str(tmp_path / "inference.json"),
                      "--model_config", str(tmp_path / "model.json")]) == 0
    assert "Loaded model parameters from" in capsys.readouterr().out
    outputs = sorted((tmp_path / "R").glob("*_bb.json"))
    assert len(outputs) == 8
    boxes = json.loads(outputs[0].read_text())
    assert len(boxes) == FRAMES and all(isinstance(v, int) for b in boxes for v in b)


def test_profile_dir_and_debug_nans(fixture_splits, tmp_path):
    """`profile_dir` writes a torch.profiler trace of the first epoch;
    `debug_nans` runs the steps under anomaly detection."""
    (train_pred, train_labels, train_cont), _ = fixture_splits
    data = ingest_directory(train_pred, train_labels, 6, train_cont)
    config = _train_config(tmp_path, 1, device="cpu", profile_dir=str(tmp_path / "trace"),
                           debug_nans=True)
    result = training_main(get_model_spec("opnet"), data, data, config, NARROW)
    assert [h["epoch"] for h in result.history] == [1]
    assert len(list((tmp_path / "trace").glob("*.json"))) == 1
