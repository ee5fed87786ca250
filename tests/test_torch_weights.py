"""The weight bridge and the port's npz checkpoints.

The bridge copies values, so every comparison here is exact (bit for bit).
"""

import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from objectpermanence_tpu.config import load_model_config as jax_load_model_config
from objectpermanence_tpu.models.reasoning import opnet_init
from objectpermanence_tpu.utils.checkpoint import restore_params, save_params as jax_save_params
from objectpermanence_tpu_torch.models.convert import params_from_jax, params_to_jax
from objectpermanence_tpu_torch.models.reasoning import OPNet
from objectpermanence_tpu_torch.models.registry import init_model
from objectpermanence_tpu_torch.utils.checkpoint import (
    best_params_checkpoint, load_params, save_params,
)
from torch_lane import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FLAGSHIP_ORBAX = REPO / "bench_data" / "checkpoints" / "opnet" / "19-08-26_0.514"
FLAGSHIP_NPZ = REPO / "objectpermanence_tpu_torch" / "assets" / "opnet_19-08-26_0.514.npz"
SMALL = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 8,
         "videos_hidden_dim": 12}


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_bridge_round_trip_is_exact(seed):
    params = jax.device_get(opnet_init(jax.random.PRNGKey(seed), SMALL))
    state = params_from_jax(params)
    assert list(state) == ["att_head.w", "att_lstm.w_hh", "att_lstm.w_ih", "box_head.w",
                           "video_lstm.w_hh", "video_lstm.w_ih"]
    _assert_trees_equal(params_to_jax(state), params)
    # and the state_dict fits the port's module exactly (strict load)
    model = OPNet(SMALL)
    model.load_state_dict(state)
    _assert_trees_equal(params_to_jax(model.state_dict()), params)


def test_committed_npz_equals_orbax_flagship():
    like = opnet_init(jax.random.PRNGKey(0), jax_load_model_config("opnet"))
    want = jax.device_get(restore_params(FLAGSHIP_ORBAX, like))
    got = params_to_jax(load_params(FLAGSHIP_NPZ))
    _assert_trees_equal(got, want)


def test_npz_save_load_round_trip(tmp_path):
    state = OPNet(SMALL, torch.Generator().manual_seed(3)).state_dict()
    path = save_params(tmp_path / "x" / "ckpt.npz", state)
    loaded = load_params(path)
    assert list(loaded) == list(state)
    for key in state:
        assert torch.equal(loaded[key], state[key])


def test_best_checkpoint_picks_highest_dev_miou(tmp_path):
    state = OPNet(SMALL).state_dict()
    for name in ("19-08-26_0.514.npz", "20-08-26_0.601.npz", "21-08-26_0.550.npz",
                 "notes.npz"):
        save_params(tmp_path / name, state)
    assert best_params_checkpoint(tmp_path).name == "20-08-26_0.601.npz"
    assert best_params_checkpoint(tmp_path / "missing") is None


def test_tie_on_miou_picks_most_recent(tmp_path):
    state = OPNet(SMALL).state_dict()
    old = save_params(tmp_path / "a_0.5.npz", state)
    new = save_params(tmp_path / "b_0.5.npz", state)
    os.utime(old, (1_000_000, 1_000_000))
    os.utime(new, (2_000_000, 2_000_000))
    assert best_params_checkpoint(tmp_path) == new


def test_orbax_checkpoint_raises_with_conversion_hint(tmp_path):
    params = jax.device_get(opnet_init(jax.random.PRNGKey(0), SMALL))
    leaf = tmp_path / "opnet" / "19-08-26_0.5"
    jax_save_params(leaf, params)
    for path in (leaf, leaf.parent):
        with pytest.raises(ValueError, match="export_torch_weights"):
            init_model("opnet", SMALL, checkpoint_path=str(path), device="cpu")


def test_init_model_loads_checkpoint_tree(tmp_path):
    state = OPNet(SMALL, torch.Generator().manual_seed(9)).state_dict()
    save_params(tmp_path / "opnet" / "01-01-26_0.3.npz", OPNet(SMALL).state_dict())
    save_params(tmp_path / "opnet" / "02-01-26_0.7.npz", state)
    _, model = init_model("opnet", SMALL, checkpoint_path=str(tmp_path / "opnet"),
                          device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key])
    with pytest.raises(FileNotFoundError):
        init_model("opnet", SMALL, checkpoint_path=str(tmp_path), device="cpu")
