"""The port's `analysis` and `cater_inference` against the JAX package's, on
the CPU: the analyzer's CSV byte for byte on fixture predictions and labels
with every mask file, its parts (ground-truth and mask parsing, the IoU,
the precision sweep), the homography's grid classes, and both CLI modes.

Host code is the same numpy and pandas arithmetic on both sides, so the
CSVs and grid classes must be equal exactly. `cater_inference` holds the
same seeded weights on both sides; its classes come from pixel boxes,
which may differ by a pixel where a float lies within rounding of an
integer (`tests/test_torch_infer.py`), so its CSV is held equal on
fixtures where no box moved.
"""

import json

import jax
import numpy as np
import pytest

from objectpermanence_tpu.analysis import analyzer as jax_analyzer
from objectpermanence_tpu.analysis.offline import analyze_results as jax_analyze_results
from objectpermanence_tpu.infer.cater_setup import cater_setup_inference as jax_cater_setup
from objectpermanence_tpu.models.reasoning import baseline_lstm_init, opnet_init
from objectpermanence_tpu.ops import homography as jax_homography
from objectpermanence_tpu_torch.__main__ import main as port_main
from objectpermanence_tpu_torch.analysis import analyzer
from objectpermanence_tpu_torch.analysis.offline import analyze_results
from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
from objectpermanence_tpu_torch.models.convert import params_from_jax
from objectpermanence_tpu_torch.ops import homography
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_lane import one_torch_thread  # noqa: F401

VIDEOS, FRAMES = 8, 300
MASK_FLAGS = ("containment_only_static", "containment_with_movements", "visibility_gt_0",
              "visibility_gt_30", "visibility_gt_99")


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """Fixture labels, seeded predictions around them (one video with the
    -100 defect marker, one prediction without labels) and seeded mask
    files, one per annotation flag."""
    root = tmp_path_factory.mktemp("analysis")
    pred_dir, labels_dir, containment = write_fixture_dataset(root / "data", num_videos=VIDEOS,
                                                              seed=4)
    rng = np.random.RandomState(5)
    predictions = root / "predictions"
    predictions.mkdir()
    names = sorted(p.name[:-len("_bb.json")] for p in labels_dir.glob("*_bb.json"))
    for i, name in enumerate(names):
        gt = jax_analyzer.parse_gt_bb_json(labels_dir / f"{name}_bb.json")
        boxes = np.round(gt + rng.randint(-6, 7, gt.shape) * (i % 3)).astype(np.int64)
        if i == 5:
            boxes[17, 1] = jax_analyzer.DEFECT_SENTINEL
        analyzer.write_bb_predictions(name, predictions, boxes)
    analyzer.write_bb_predictions("CATER_unlabelled", predictions,
                                  np.zeros((FRAMES, 4), np.int64))
    masks = {}
    for k, flag in enumerate(MASK_FLAGS):
        lines = []
        for name in names[k % 2:]:      # some videos have no line
            frames = np.flatnonzero(rng.rand(FRAMES) < 0.1 * (k + 1))
            lines.append(f"{name}\t{','.join(map(str, frames))}")
        masks[flag] = root / f"{flag}.txt"
        masks[flag].write_text("\n".join(lines + [f"{names[0]}_other\t1,2"]) + "\n")
    return predictions, labels_dir, containment, masks, pred_dir


@pytest.mark.parametrize("flags", ["none", "containment", "visibility", "all"])
def test_analyze_results_csv_is_byte_identical(flags, scored, tmp_path):
    predictions, labels_dir, containment, masks, _ = scored
    chosen = {"none": (), "containment": ("containment",),
              "visibility": ("visibility_gt_0", "visibility_gt_99"),
              "all": ("containment",) + MASK_FLAGS}[flags]
    files = {flag: str(containment if flag == "containment" else masks[flag]) for flag in chosen}
    args = [files.get(flag) for flag in ("containment",) + MASK_FLAGS]
    ours = analyze_results(predictions, labels_dir, tmp_path / "ours.csv", *args,
                           iou_thresh=[0.5, 0.75, 0.9])
    jax_analyze_results(predictions, labels_dir, tmp_path / "jax.csv", *args,
                        iou_thresh=[0.5, 0.75, 0.9])
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert len(ours.video_names) == VIDEOS - 1    # the defect video is skipped
    header = (tmp_path / "ours.csv").read_text().splitlines()[0].split(",")
    assert "overall_iou" in header and "overall_map_0.9" in header
    if flags == "all":
        assert "full_occlusion_mean_iou" in header and "static_contained_ratio" in header


def test_analyzer_parts_match_jax(scored):
    predictions, labels_dir, _, masks, _ = scored
    ours = analyzer.ResultsAnalyzer.init_from_files(predictions, labels_dir, [0.5])
    theirs = jax_analyzer.ResultsAnalyzer.init_from_files(predictions, labels_dir, [0.5])
    assert ours.video_names == theirs.video_names
    np.testing.assert_array_equal(ours.iou, theirs.iou)
    assert ours.iou.dtype == np.float64
    for flag in MASK_FLAGS:
        a, b = ours.frames_mask(masks[flag]), theirs.frames_mask(masks[flag])
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    ours.compute_precision_data(masks=ours.frames_mask(masks["visibility_gt_30"]))
    theirs.compute_precision_data(masks=theirs.frames_mask(masks["visibility_gt_30"]))
    ours.compute_precision_data()
    theirs.compute_precision_data()
    assert ours.get_analysis_df().equals(theirs.get_analysis_df())


def test_grid_classes_match_jax():
    rng = np.random.RandomState(6)
    centers = np.concatenate([rng.uniform(-40, 360, (2000, 2)),
                              np.stack(np.meshgrid(np.arange(0, 321, 8),
                                                   np.arange(0, 241, 8)), -1).reshape(-1, 2)])
    np.testing.assert_array_equal(homography.H_IMAGE_TO_PLANE, jax_homography.H_IMAGE_TO_PLANE)
    got = homography.grid_classes_for_centers(centers)
    np.testing.assert_array_equal(got, jax_homography.grid_classes_for_centers(centers))
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 36
    for cx, cy in rng.uniform(-1, 1, (50, 2)):
        assert (homography.get_class_prediction(cx, cy)
                == jax_homography.get_class_prediction(cx, cy))


def test_cli_analysis_on_cpu(scored, tmp_path):
    predictions, labels_dir, containment, masks, _ = scored
    argv = ["analysis", "--predictions_dir", str(predictions), "--labels_dir", str(labels_dir),
            "--containment_annotations", str(containment), "--visibility_ratio_gt_0",
            str(masks["visibility_gt_0"]), "--iou_thresholds", "0.5,0.9",
            "--output_file", str(tmp_path / "out.csv")]
    assert port_main(argv) == 0
    jax_analyze_results(predictions, labels_dir, tmp_path / "jax.csv", str(containment),
                        visibility_gt_0=str(masks["visibility_gt_0"]), iou_thresh=[0.5, 0.9])
    assert (tmp_path / "out.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    with pytest.raises(ValueError):
        port_main(argv[:-4] + ["--iou_thresholds", "abc", "--output_file", "x.csv"])


SMALL = {"opnet": {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
                   "videos_hidden_dim": 24},
         "baseline_lstm": {"videos_hidden_dim": 16}}


@pytest.mark.parametrize("name", ["opnet", "baseline_lstm"])
def test_cli_cater_inference_matches_jax(name, scored, tmp_path):
    _, labels_dir, _, _, pred_dir = scored
    init = {"opnet": opnet_init, "baseline_lstm": baseline_lstm_init}[name]
    params = jax.device_get(init(jax.random.PRNGKey(0), SMALL[name]))
    config = {"sample_dir": str(pred_dir), "labels_dir": str(labels_dir), "batch_size": 8}
    want = jax_cater_setup(name, str(tmp_path / "jax"), config, SMALL[name])

    weights = save_params(tmp_path / "weights.npz", params_from_jax(params))
    (tmp_path / "inference.json").write_text(json.dumps(
        {**config, "batch_size": 3, "device": "cpu", "model_path": str(weights)}))
    (tmp_path / "model.json").write_text(json.dumps(SMALL[name]))
    assert port_main(["cater_inference", "--model_type", name, "--results_dir",
                      str(tmp_path / "port"), "--inference_config",
                      str(tmp_path / "inference.json"), "--model_config",
                      str(tmp_path / "model.json")]) == 0
    ours = tmp_path / "port" / "class_pred_results.csv"
    assert ours.read_bytes() == (tmp_path / "jax" / "class_pred_results.csv").read_bytes()
    assert len(want) == VIDEOS and want["class_predictions"].between(0, 35).all()
