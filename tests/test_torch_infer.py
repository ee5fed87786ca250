"""The port's ingest, inference entry point, CLI and configs against the JAX
package's, on fixture datasets written from a seed.

Ingest is exact (the same numpy arithmetic). Predicted pixel boxes may
differ by one pixel where a float lies within rounding of an integer: at
most 1 px apart on at most 0.1% of the coordinates.
"""

import dataclasses
import json
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest

from objectpermanence_tpu.config import ConfigError as JaxConfigError
from objectpermanence_tpu.config import inference_config_from as jax_inference_config_from
from objectpermanence_tpu.data.fixtures import write_fixture_dataset as jax_write_fixture_dataset
from objectpermanence_tpu.data.ingest import ingest_directory as jax_ingest_directory
from objectpermanence_tpu.infer.reasoning import (
    reasoning_inference_main as jax_reasoning_inference_main,
)
from objectpermanence_tpu.models.reasoning import opnet_init
from objectpermanence_tpu.utils.checkpoint import save_params as jax_save_params
from objectpermanence_tpu_torch.__main__ import main as port_main
from objectpermanence_tpu_torch.config import ConfigError, inference_config_from, load_model_config
from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
from objectpermanence_tpu_torch.data.ingest import batches, ingest_directory
from objectpermanence_tpu_torch.infer.reasoning import reasoning_inference_main
from objectpermanence_tpu_torch.models.convert import params_from_jax
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.utils.checkpoint import save_params

SMALL = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 32,
         "videos_hidden_dim": 64}


@pytest.fixture(scope="module")
def fixture_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixture")
    pred_dir, labels_dir, containment = write_fixture_dataset(root, num_videos=8, seed=3)
    return pred_dir, labels_dir, containment


def test_fixture_writer_matches_jax(fixture_data, tmp_path):
    pred_dir, labels_dir, _ = fixture_data
    root = pred_dir.parent
    jax_root = tmp_path / "jax"
    jax_write_fixture_dataset(jax_root, num_videos=8, seed=3)
    ours = sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())
    theirs = sorted(p.relative_to(jax_root) for p in jax_root.rglob("*") if p.is_file())
    assert ours == theirs and len(ours) == 8 + 8 + 6
    for rel in ours:
        if rel.suffix == ".pkl":
            with open(root / rel, "rb") as a, open(jax_root / rel, "rb") as b:
                mine, want = pickle.load(a), pickle.load(b)
            for key in ("bb", "labels"):
                assert all(np.array_equal(x, y) for x, y in zip(mine[key], want[key]))
        else:
            assert (root / rel).read_bytes() == (jax_root / rel).read_bytes()


@pytest.mark.parametrize("feature_width", [5, 6])
def test_ingest_matches_jax_exactly(fixture_data, feature_width):
    pred_dir, labels_dir, containment = fixture_data
    ours = ingest_directory(pred_dir, labels_dir, feature_width, containment)
    want = jax_ingest_directory(pred_dir, labels_dir, feature_width, containment)
    assert ours.names == want.names and len(ours) == 8
    for field in ("boxes", "index_to_track", "labels", "containment_mask"):
        a, b = getattr(ours, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_ingest_cache_round_trip(fixture_data, tmp_path):
    pred_dir, labels_dir, _ = fixture_data
    first = ingest_directory(pred_dir, labels_dir, 6, cache_dir=tmp_path)
    cached = list(tmp_path.glob("ingest_*.npz"))
    assert len(cached) == 1
    second = ingest_directory(pred_dir, labels_dir, 6, cache_dir=tmp_path)
    for field in ("boxes", "index_to_track", "labels"):
        assert np.array_equal(getattr(first, field), getattr(second, field))


def test_batches_cover_dataset_in_order(fixture_data):
    pred_dir, labels_dir, _ = fixture_data
    dataset = ingest_directory(pred_dir, labels_dir, 6)
    got = list(batches(dataset, 3))
    assert [len(b["names"]) for b in got] == [3, 3, 2]
    assert sum((b["names"] for b in got), []) == dataset.names
    assert np.array_equal(np.concatenate([b["boxes"] for b in got]), dataset.boxes)


def test_inference_matches_jax_inference(fixture_data, tmp_path):
    pred_dir, labels_dir, _ = fixture_data
    params = jax.device_get(opnet_init(jax.random.PRNGKey(11), SMALL))
    jax_ckpt = tmp_path / "jax_ckpt" / "opnet" / "01-01-26_0.5"
    jax_save_params(jax_ckpt, params)
    port_ckpt = save_params(tmp_path / "port_ckpt" / "opnet" / "01-01-26_0.5.npz",
                            params_from_jax(params))
    config = {"sample_dir": str(pred_dir), "labels_dir": str(labels_dir), "batch_size": 8,
              "device": "tpu"}

    jax_reasoning_inference_main("opnet", str(tmp_path / "jax_out"),
                                 {**config, "model_path": str(jax_ckpt.parent)}, SMALL)
    ours = reasoning_inference_main("opnet", str(tmp_path / "port_out"),
                                    {**config, "model_path": str(port_ckpt.parent),
                                     "batch_size": 3}, SMALL, device="cpu")
    assert len(ours) == 8
    jax_files = sorted(p.name for p in (tmp_path / "jax_out").glob("*_bb.json"))
    port_files = sorted(p.name for p in (tmp_path / "port_out").glob("*_bb.json"))
    assert port_files == jax_files and len(port_files) == 8
    diffs = []
    for name in port_files:
        mine = np.array(json.loads((tmp_path / "port_out" / name).read_text()))
        want = np.array(json.loads((tmp_path / "jax_out" / name).read_text()))
        assert mine.shape == want.shape == (300, 4)
        diffs.append(np.abs(mine - want))
    diffs = np.stack(diffs)
    assert diffs.max() <= 1
    assert (diffs > 0).mean() <= 1e-3


def test_cli_inference_on_cpu(fixture_data, tmp_path):
    pred_dir, labels_dir, _ = fixture_data
    (tmp_path / "inference.json").write_text(json.dumps(
        {"sample_dir": str(pred_dir), "labels_dir": str(labels_dir), "batch_size": 4,
         "device": "cpu", "cache_dir": str(tmp_path / "cache")}))
    (tmp_path / "model.json").write_text(json.dumps(SMALL))
    rc = port_main(["inference", "--model_type", "opnet", "--results_dir",
                    str(tmp_path / "R"), "--inference_config", str(tmp_path / "inference.json"),
                    "--model_config", str(tmp_path / "model.json")])
    assert rc == 0
    outputs = sorted((tmp_path / "R").glob("*_bb.json"))
    assert len(outputs) == 8
    boxes = json.loads(outputs[0].read_text())
    assert len(boxes) == 300 and all(len(b) == 4 and all(isinstance(v, int) for v in b)
                                     for b in boxes)


@pytest.mark.parametrize("argv", [
    ["inference", "--model_type", "detector_heuristic", "--results_dir", "r",
     "--inference_config", "i"],
    ["inference", "--model_type", "detector_tracker", "--results_dir", "r",
     "--inference_config", "i"],
])
def test_cli_modes_not_ported_exit_nonzero(argv, fixture_data, tmp_path):
    """Every model name now runs: the programmed models go to
    `infer/trackers.py` without a --model_config. The heuristic writes a box
    per frame of each fixture video; detector_tracker with no video raises
    FileNotFoundError, as JAX's `trackers_inference_main` does."""
    pred_dir, labels_dir, _ = fixture_data
    (tmp_path / "i").write_text(json.dumps({"sample_dir": str(pred_dir),
                                            "labels_dir": str(labels_dir), "device": "cpu"}))
    argv = [str(tmp_path / a) if a in ("r", "i") else a for a in argv]
    if argv[2] == "detector_tracker":
        with pytest.raises(FileNotFoundError, match="needs raw video pixels"):
            port_main(argv)
        return
    assert port_main(argv) == 0
    outputs = sorted((tmp_path / "r").glob("*_bb.json"))
    assert len(outputs) == 8 and len(json.loads(outputs[0].read_text())) == 300


@pytest.mark.parametrize("name", ["detector_tracker", "detector_heuristic"])
def test_registry_names_roadmap_item_for_unported_models(name):
    """The programmed models have no learned-model spec, in the port as in
    JAX: both registries raise ValueError for them."""
    from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
    from objectpermanence_tpu_torch.models.registry import INFERENCE_SUPPORTED_MODELS
    assert name in INFERENCE_SUPPORTED_MODELS
    with pytest.raises(ValueError, match="Unknown model name"):
        get_model_spec(name)
    with pytest.raises(ValueError, match="Unknown model name"):
        jax_get_model_spec(name)


def test_registry_opnet_family():
    for name in ("opnet", "opnet_no_labels", "opnet_att_ce"):
        spec = get_model_spec(name, load_model_config(name))
        assert spec.feature_width == 6 and spec.double_output
    assert get_model_spec("opnet_no_labels").no_labels
    assert get_model_spec("opnet_att_ce", load_model_config("opnet_att_ce")).att_ce_weight == 0.1
    with pytest.raises(ValueError):
        get_model_spec("no_such_model")


def test_unknown_config_keys_raise_in_both():
    bad = {"sample_dir": "s", "labels_dir": "l", "containment_file": "c"}
    with pytest.raises(ConfigError, match="containment_file"):
        inference_config_from(bad)
    with pytest.raises(JaxConfigError, match="containment_file"):
        jax_inference_config_from(bad)
    with pytest.raises(ConfigError, match="missing"):
        inference_config_from({"sample_dir": "s"})


def test_shipped_inference_config_parses():
    shipped = json.loads((Path(__file__).resolve().parent.parent / "configs" /
                          "inference_config.json").read_text())
    ours, want = inference_config_from(shipped), jax_inference_config_from(shipped)
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert ours.device == "tpu"  # which the port reads as the card
