"""The port's experiment drivers (`objectpermanence_tpu_torch/experiments/`)
against the JAX package's scripts (`scripts/<name>.py`, imported as the
namespace package `scripts` from the repository root), on the CPU at a
small seeded scale: 16 train, 2 dev and 3 test scenes of 60 frames. The
train split (16) and the sweep's cut of it (8) are multiples of the 8-device
CPU mesh of `tests/conftest.py`, to which JAX's loop rounds its eval batch
(and so the padding its eval loss averages over); the port's rounds to 1.

Both drivers run on the same seeds, each on its own root. Models are
narrow (hidden 16/24) and the port's start from the JAX init, crossed
through `models/convert.py`; checkpoints the JAX runs write cross as `.npz`
the same way. Tolerances, with their reasons:
- datagen and `make_unbsub`: byte for byte (the pieces are byte-exact);
- training: losses rtol 1e-4 and mean IoUs atol 1e-3, with the same
  "Saved best model" lines (`tests/test_torch_train.py`'s: float32 sums in
  another order, and a box within rounding of an integer pixel can flip);
- the analysis CSV on the same weights: each column within 1e-6;
- the rows of `variant_sweep`, `cater_grid_run` and `unbiased_eval` on the
  same weights: equal (they are rounded to 4 decimals); after training,
  `best_dev_miou` within 1e-3, the other scores equal;
- `moe_balance`'s fractions and mean gate on the same weights: within 1e-6.
"""

import json
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest

import objectpermanence_tpu.config as jax_config
import scripts.cater_grid_run as jax_cater_grid_run
import scripts.containment_run as jax_containment_run
import scripts.make_unbsub as jax_make_unbsub
import scripts.moe_balance as jax_moe_balance
import scripts.unbiased_eval as jax_unbiased_eval
import scripts.variant_sweep as jax_variant_sweep
from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
from objectpermanence_tpu.utils.checkpoint import best_params_checkpoint as jax_best
from objectpermanence_tpu.utils.checkpoint import restore_params
from objectpermanence_tpu.utils.checkpoint import save_params as jax_save_params
from objectpermanence_tpu_torch.experiments import (
    cater_grid_run, containment_run, make_unbsub, moe_balance, unbiased_eval, variant_sweep,
)
from objectpermanence_tpu_torch.models.convert import params_from_jax
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_experiment_helpers import files, from_jax_init, jax_main, run_quiet
from torch_lane import one_torch_thread  # noqa: F401

NARROW = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
          "videos_hidden_dim": 24}
FRAMES, OBJECTS = 60, 8
SPLITS = (("train", 16, 1), ("dev", 2, 2), ("test", 3, 3))  # split, scenes, seed
EPOCHS = 2
SWEPT = ("opnet", "opnet_no_labels")


def _export(leaf, name, out):
    """A JAX params checkpoint (orbax leaf) as the port's npz."""
    like = jax_get_model_spec(name, NARROW).init(jax.random.PRNGKey(0), NARROW)
    return save_params(out, params_from_jax(jax.device_get(restore_params(leaf, like))))


def _saved(text):
    return [line for line in text.splitlines() if line.startswith("Saved best model")]


def _metrics(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _assert_history_close(ours, theirs):
    assert [e["epoch"] for e in ours] == [e["epoch"] for e in theirs] and ours
    for a, b in zip(ours, theirs):
        assert a["learning_rate"] == pytest.approx(b["learning_rate"], rel=1e-6)
        for split in ("train", "dev"):
            np.testing.assert_allclose(a[split]["loss"], b[split]["loss"], rtol=1e-4)
            for key in ("mean_iou", "containment_mean_iou"):
                np.testing.assert_allclose(a[split][key], b[split][key], atol=1e-3)


@pytest.fixture(scope="module")
def narrow():
    """Narrow configs for both packages' drivers, and the port's models
    built from the JAX init. The variants share OPNet's config, as in the
    scripts' MODEL_CONFIGS."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_config, "load_model_config", lambda name: dict(NARROW))
        mp.setattr(containment_run, "load_model_config", lambda name: dict(NARROW))
        mp.setattr(moe_balance, "load_model_config", lambda name: dict(NARROW))
        for configs in (jax_variant_sweep.MODEL_CONFIGS, variant_sweep.MODEL_CONFIGS):
            for name in ("opnet", "opnet_no_labels", "opnet_moe"):
                mp.setitem(configs, name, NARROW)
        for module in (containment_run, variant_sweep):
            mp.setattr(module, "get_model_spec", from_jax_init(module.get_model_spec, NARROW))
        yield


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("experiments")
    jax_root, port_root = base / "jax", base / "port"
    for split, scenes, seed in SPLITS:
        run_quiet(jax_containment_run.gen_split, jax_root, split, scenes, seed, FRAMES, OBJECTS)
        run_quiet(containment_run.gen_split, port_root, split, scenes, seed, FRAMES, OBJECTS)
    return jax_root, port_root


@pytest.fixture(scope="module")
def trained(roots, narrow):
    """`train` of both: OPNet, the reference recipe, EPOCHS epochs."""
    jax_root, port_root = roots
    jax_out = run_quiet(jax_containment_run.train, jax_root, EPOCHS, False)
    port_out = run_quiet(containment_run.train, port_root, EPOCHS, False, "cpu")
    return jax_out, port_out


@pytest.fixture(scope="module")
def swept(roots, narrow):
    """`variant_sweep` of both over SWEPT, the train split cut to 8 videos;
    records the mask file the port's sweep ingested for each model."""
    jax_root, port_root = roots
    argv = ["--epochs", str(EPOCHS), "--train-limit", "8", "--models", *SWEPT]
    jax_main(jax_variant_sweep, ["--root", str(jax_root), *argv])
    masks = []
    real = variant_sweep.ingest_directory

    def spy(*args):
        masks.append(args[3])
        return real(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(variant_sweep, "ingest_directory", spy)
        run_quiet(variant_sweep.main, ["--root", str(port_root), *argv, "--device", "cpu"])
    return masks


@pytest.fixture(scope="module")
def converted(roots, swept, tmp_path_factory):
    """A root for the port whose sweep checkpoint of opnet is the JAX
    sweep's best, as an npz; its test split is the port's."""
    jax_root, port_root = roots
    root = tmp_path_factory.mktemp("converted")
    (root / "test").symlink_to(port_root / "test")
    leaf = jax_best(jax_root / "sweep" / "opnet" / "opnet")
    _export(leaf, "opnet", root / "sweep" / "opnet" / "opnet" / f"{leaf.name}.npz")
    return root


def test_gen_split_bytes_equal(roots):
    jax_root, port_root = roots
    ours, theirs = files(port_root), files(jax_root)
    assert sorted(ours) == sorted(theirs)
    for split, scenes, _ in SPLITS:
        assert len(list((port_root / split / "od_perception").glob("*.pkl"))) == scenes
    for key in theirs:
        assert ours[key] == theirs[key], key


@pytest.mark.parametrize("module", [jax_containment_run, containment_run],
                         ids=["jax", "port"])
def test_gen_split_pre_v2_marker(module, roots, tmp_path):
    """An unversioned marker is checked by re-simulating video 0: kept and
    upgraded when the scene matches, refused when it does not."""
    _, port_root = roots
    split = tmp_path / "dev"
    shutil.copytree(port_root / "dev", split)
    (split / ".done").write_text("done\n")
    run_quiet(module.gen_split, tmp_path, "dev", 2, 2, FRAMES, OBJECTS)
    assert (split / ".done").read_text() == "seed_scheme=v2\n"
    (split / ".done").write_text("done\n")
    with pytest.raises(RuntimeError, match="pre-v2 seed scheme"):
        run_quiet(module.gen_split, tmp_path, "dev", 2, 3, FRAMES, OBJECTS)


def test_train_matches_jax(roots, trained):
    jax_root, port_root = roots
    jax_out, port_out = trained
    _assert_history_close(_metrics(port_root / "metrics.jsonl"),
                          _metrics(jax_root / "metrics.jsonl"))
    assert _saved(port_out) == _saved(jax_out) and _saved(port_out)
    assert sorted(p.stem for p in (port_root / "checkpoints" / "opnet").glob("*.npz")) == \
        sorted(p.name for p in (jax_root / "checkpoints" / "opnet").iterdir()
               if p.name != "resume")


def test_analyze_csv_matches_jax(roots, trained, tmp_path):
    """`analyze` of both on JAX's trained weights (the port's as an npz)."""
    jax_root, port_root = roots
    (tmp_path / "test").symlink_to(port_root / "test")
    leaf = jax_best(jax_root / "checkpoints" / "opnet")
    _export(leaf, "opnet", tmp_path / "checkpoints" / "opnet" / f"{leaf.name}.npz")
    run_quiet(jax_containment_run.analyze, jax_root)
    run_quiet(containment_run.analyze, tmp_path, "cpu")
    boxes = files(tmp_path / "results")
    assert len(boxes) == 3 and boxes == files(jax_root / "results")
    ours = pd.read_csv(tmp_path / "analysis.csv")
    theirs = pd.read_csv(jax_root / "analysis.csv")
    assert list(ours.columns) == list(theirs.columns) and len(ours) == 3
    assert list(ours["videos_names"]) == list(theirs["videos_names"])
    for column in theirs.columns[1:]:
        np.testing.assert_allclose(ours[column].to_numpy(float), theirs[column].to_numpy(float),
                                   rtol=0, atol=1e-6, err_msg=column)


def test_variant_sweep_rows_match_jax(roots, swept):
    jax_root, port_root = roots
    ours = json.loads((port_root / "sweep" / "results.json").read_text())
    theirs = json.loads((jax_root / "sweep" / "results.json").read_text())
    assert [r["model"] for r in ours] == [r["model"] for r in theirs] == list(SWEPT)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        assert a["best_dev_miou"] == pytest.approx(b["best_dev_miou"], abs=1e-3)
        for key in ("test_overall_iou", "test_contained_iou", "test_visible_iou",
                    "test_map_0.5"):
            assert a[key] == b[key], (a["model"], key)
    for model in SWEPT:
        _assert_history_close(_metrics(port_root / "sweep" / model / "metrics.jsonl"),
                              _metrics(jax_root / "sweep" / model / "metrics.jsonl"))


def test_variant_sweep_no_labels_trains_on_visibility_file(roots, swept):
    """`training_mask_file`: the containment file for opnet, the visible
    frames for opnet_no_labels (whose masked loss matched JAX's above)."""
    _, port_root = roots
    assert [(p.parent.name, p.name) for p in swept] == [
        ("annotations", "containment_annotations.txt")] * 2 + [
        ("od_perception", "visibility_rate_gt_0.99.txt")] * 2
    assert swept[2].parent.parent == port_root / "train"


def test_variant_sweep_eval_only_reads_npz_name(roots, swept):
    """--eval-only with no prior row takes the best dev mIoU from the
    checkpoint's name: the port's `<stamp>_<miou>.npz`, JAX's directory."""
    jax_root, port_root = roots
    leaf = jax_best(jax_root / "sweep" / "opnet" / "opnet")
    jax_copy = jax_root / "sweep_eval" / "opnet" / "opnet" / "01-01-26_0.448"
    shutil.copytree(leaf, jax_copy)
    _export(leaf, "opnet", port_root / "sweep_eval" / "opnet" / "opnet" / "01-01-26_0.448.npz")
    argv = ["--sweep-dir", "sweep_eval", "--eval-only", "--models", "opnet"]
    jax_main(jax_variant_sweep, ["--root", str(jax_root), *argv])
    run_quiet(variant_sweep.main, ["--root", str(port_root), *argv, "--device", "cpu"])
    ours = json.loads((port_root / "sweep_eval" / "results.json").read_text())
    theirs = json.loads((jax_root / "sweep_eval" / "results.json").read_text())
    assert ours == theirs
    assert ours[0]["best_dev_miou"] == 0.448 and ours[0]["train_seconds"] == -1


def test_cater_grid_helpers_match_jax(roots):
    jax_root, _ = roots
    scenes = jax_root / "test" / "scenes"
    assert cater_grid_run.gt_grid_classes(scenes) == jax_cater_grid_run.gt_grid_classes(scenes)
    assert [cater_grid_run.grid_l1(a, b) for a in range(36) for b in range(36)] == \
        [jax_cater_grid_run.grid_l1(a, b) for a in range(36) for b in range(36)]


def test_cater_grid_run_row_matches_jax(roots, converted):
    """The row and the class table on the same weights; a model with no
    checkpoint is skipped by both."""
    jax_root, _ = roots
    argv = ["--models", "opnet", "transformer_lstm"]
    jax_out = jax_main(jax_cater_grid_run, ["--root", str(jax_root), *argv])
    port_out = run_quiet(cater_grid_run.main, ["--root", str(converted), *argv, "--device", "cpu"])
    ours = json.loads((converted / "cater" / "grid_results.json").read_text())
    theirs = json.loads((jax_root / "cater" / "grid_results.json").read_text())
    assert ours == theirs and [r["model"] for r in ours] == ["opnet"]
    assert ours[0]["videos"] == 3
    assert (converted / "cater" / "opnet" / "class_pred_results.csv").read_bytes() == \
        (jax_root / "cater" / "opnet" / "class_pred_results.csv").read_bytes()
    for out in (jax_out, port_out):
        assert "[cater] transformer_lstm: no checkpoint under" in out


def test_unbiased_eval_matches_jax(roots, converted, tmp_path):
    """The uniform-planner split byte for byte, and its row on the same
    weights (the JAX sweep's opnet); an orbax tree makes the port raise."""
    jax_root, _ = roots
    argv = ["--videos", "3", "--frames", str(FRAMES), "--models", "opnet"]
    jax_main(jax_unbiased_eval, ["--root", str(tmp_path / "jax"), *argv,
                                  "--checkpoints-root", str(jax_root)])
    run_quiet(unbiased_eval.main, ["--root", str(tmp_path / "port"), *argv,
                              "--checkpoints-root", str(converted), "--device", "cpu"])
    split = {k: v for k, v in files(tmp_path / "port").items()
             if k.split(os.sep)[0] in ("scenes", "labels", "annotations", "od_perception")}
    theirs = files(tmp_path / "jax")
    assert split and all(theirs[k] == v for k, v in split.items())
    ours = json.loads((tmp_path / "port" / "results.json").read_text())
    assert ours == json.loads((tmp_path / "jax" / "results.json").read_text())
    with pytest.raises(ValueError, match="export_torch_weights"):
        run_quiet(unbiased_eval.main, ["--root", str(tmp_path / "port"), *argv,
                                  "--checkpoints-root", str(jax_root), "--device", "cpu"])


def test_make_unbsub_tree_matches_jax(roots, tmp_path):
    jax_root, _ = roots
    argv = ["--src", str(jax_root), "--train", "3", "--dev", "1"]
    jax_main(jax_make_unbsub, [*argv, "--out", str(tmp_path / "jax")])
    run_quiet(make_unbsub.main, [*argv, "--out", str(tmp_path / "port")])
    ours, theirs = files(tmp_path / "port"), files(tmp_path / "jax")
    assert ours == theirs
    assert ours["test"] == ("link", str(jax_root / "test"))
    assert sum(1 for v in ours.values() if isinstance(v, tuple)) == 2 * (3 + 1) + 3


def test_moe_balance_matches_jax(roots, narrow, tmp_path):
    """The report on the same opnet_moe weights (seeded, JAX's init), over
    the 3 test videos in batches of 2: a ragged last batch."""
    jax_root, port_root = roots
    params = jax_get_model_spec("opnet_moe", NARROW).init(jax.random.PRNGKey(3), NARROW)
    jax_save_params(tmp_path / "jax" / "opnet_moe" / "01-01-26_0.5", params)
    save_params(tmp_path / "port" / "opnet_moe" / "01-01-26_0.5.npz",
                params_from_jax(jax.device_get(params)))
    jax_main(jax_moe_balance, ["--root", str(jax_root), "--batch", "2",
                                "--ckpt-dir", str(tmp_path / "jax" / "opnet_moe")])
    run_quiet(moe_balance.main, ["--root", str(port_root), "--batch", "2", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "port" / "opnet_moe")])
    ours = json.loads((tmp_path / "port" / "moe_balance.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "moe_balance.json").read_text())
    assert ours.keys() == theirs.keys()
    assert ours["checkpoint"].endswith("01-01-26_0.5.npz") and ours["videos"] == 3
    np.testing.assert_allclose(ours["expert_fraction"], theirs["expert_fraction"], atol=1e-6)
    assert sum(ours["expert_fraction"]) == pytest.approx(1.0, abs=1e-3)
    for key in ("max_expert_fraction", "mean_gate_prob"):
        assert ours[key] == pytest.approx(theirs[key], abs=1e-6), key
