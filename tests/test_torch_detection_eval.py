"""The port's detection data and metrics against the JAX package's.

- `analysis/detection_eval.py::evaluate_detections` gives JAX's floats,
  exactly, on the same predictions: perfect, empty, shifted, and random
  sets with classes missing from the predictions or the ground truth.
- `data/detection_dataset.py::DetectionDataset` parses the reference CSV
  (class names and integer ids) and yields batches equal to JAX's, array
  for array, shuffled or not, the repeat-padded tail included, on PNG
  frames written here with PIL from the fixture scenes
  (`data/fixtures.py::write_detection_fixture`).
"""

import numpy as np
import pytest

from objectpermanence_tpu.analysis.detection_eval import evaluate_detections as jax_evaluate
from objectpermanence_tpu.data.detection_dataset import DetectionDataset as JaxDataset
from objectpermanence_tpu_torch.analysis.detection_eval import evaluate_detections
from objectpermanence_tpu_torch.data.detection_dataset import (
    MAX_GT_BOXES, DetectionDataset, parse_annotations_csv,
)
from objectpermanence_tpu_torch.data.fixtures import write_detection_fixture
from torch_lane import one_torch_thread  # noqa: F401


def _random_set(rng, images=6, classes=(3, 7, 140)):
    predictions, ground_truths = [], []
    for _ in range(images):
        g = rng.randint(0, 5)
        gt_xy = rng.uniform(0, 200, (g, 2))
        gt = np.concatenate([gt_xy, gt_xy + rng.uniform(10, 60, (g, 2))], 1)
        gt_labels = rng.choice(classes, g)
        # detections: jittered copies of the ground truth and strays
        d = rng.randint(0, 8)
        src = gt[rng.randint(0, max(g, 1), d)] if g else rng.uniform(0, 200, (d, 4))
        boxes = src + rng.normal(0, 6, (d, 4))
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
        labels = rng.choice(classes + (99,), d)
        predictions.append({"boxes": boxes, "labels": labels, "scores": rng.uniform(0, 1, d)})
        ground_truths.append({"boxes": gt, "labels": gt_labels})
    return predictions, ground_truths


def _cases():
    gt = [{"boxes": np.array([[0, 0, 10, 10], [20, 20, 40, 40]], float),
           "labels": np.array([1, 2])}]
    perfect = [{"boxes": gt[0]["boxes"].copy(), "labels": gt[0]["labels"].copy(),
                "scores": np.array([0.9, 0.8])}]
    empty = [{"boxes": np.zeros((0, 4)), "labels": np.zeros(0, int), "scores": np.zeros(0)}]
    shifted = [{"boxes": np.array([[0, 0, 10, 6], [22, 20, 40, 41]], float),
                "labels": np.array([1, 2]), "scores": np.array([0.5, 0.5])}]
    cases = {"perfect": (perfect, gt), "empty": (empty, gt), "shifted": (shifted, gt)}
    for seed in range(4):
        cases[f"random{seed}"] = _random_set(np.random.RandomState(seed))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_evaluate_detections_equals_jax(name):
    predictions, ground_truths = CASES[name]
    got = evaluate_detections(predictions, ground_truths)
    want = jax_evaluate(predictions, ground_truths)
    assert set(got) == {"mAP", "AP50", "AP75"}
    for key in got:
        assert got[key] == want[key] or (np.isnan(got[key]) and np.isnan(want[key])), key


@pytest.fixture(scope="module")
def fixture_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    images_dir, csv_path, frames = write_detection_fixture(root, num_scenes=3, frames_per_scene=2,
                                                           seed=4, write_images=True)
    # a row by class name, as the reference's CSVs have them
    with open(csv_path, "a") as f:
        f.write(f"{sorted(frames)[0]},small_gold_spl_metal,5.5,6.0,16.0,14.0\n")
    return images_dir, csv_path, frames


def test_annotations_parse_as_jax_parses_them(fixture_set):
    from objectpermanence_tpu.data.detection_dataset import parse_annotations_csv as jax_parse
    _, csv_path, frames = fixture_set
    got = parse_annotations_csv(csv_path)
    assert got == jax_parse(csv_path)
    assert sorted(got) == sorted(frames)
    assert got[sorted(frames)[0]][-1] == (140, 5.5, 6.0, 16.0, 14.0)


@pytest.mark.parametrize("batch_size,shuffle", [(4, False), (4, True), (2, True), (6, False)])
def test_batches_equal_jax(fixture_set, batch_size, shuffle):
    images_dir, csv_path, frames = fixture_set
    ours, theirs = DetectionDataset(images_dir, csv_path), JaxDataset(images_dir, csv_path)
    assert len(ours) == len(theirs) == 6
    got = list(ours.batches(batch_size, shuffle=shuffle, seed=3))
    want = list(theirs.batches(batch_size, shuffle=shuffle, seed=3))
    assert len(got) == len(want) == -(-6 // batch_size)
    for g, w in zip(got, want):
        assert g["names"] == w["names"]
        for key in ("images", "gt_boxes", "gt_labels", "gt_valid"):
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape
            np.testing.assert_array_equal(g[key], w[key])
        assert g["gt_boxes"].shape == (batch_size, MAX_GT_BOXES, 4)
    # the frames the fixture drew, losslessly through PNG
    first = got[0]
    np.testing.assert_array_equal(first["images"][0], frames[first["names"][0]])
