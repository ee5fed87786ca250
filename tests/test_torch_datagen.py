"""The port's `datagen/` (simulator, scene labels, CATER task labels,
renderer) and the camera helpers of `ops/homography.py` against the JAX
package's, on the CPU, byte for byte: the same seeds give the same scene
jsons, `<name>_bb.json` boxes, annotation files, task label files, rendered
frames, detection CSV rows, sidecars, PNGs and AVIs. Then the counterpart of
`tests/test_simulator_pipeline.py`: simulate -> perfect perception ->
annotations -> ingest (the native library) -> one training epoch of the
port, its pickles and arrays equal to JAX's."""

import json
import pickle

import numpy as np
import pytest
import torch

from objectpermanence_tpu.data.ingest import ingest_directory as jax_ingest_directory
from objectpermanence_tpu.datagen import cater_tasks as jax_cater_tasks
from objectpermanence_tpu.datagen import renderer as jax_renderer
from objectpermanence_tpu.datagen import scene_labels as jax_scene_labels
from objectpermanence_tpu.datagen import simulator as jax_simulator
from objectpermanence_tpu.datagen.perfect_perception import (
    PerfectPerceptionGenerator as JaxPerfectPerception,
)
from objectpermanence_tpu.ops import homography as jax_homography
from objectpermanence_tpu_torch.data.ingest import ingest_directory
from objectpermanence_tpu_torch.datagen import cater_tasks, renderer, scene_labels
from objectpermanence_tpu_torch.datagen import simulator
from objectpermanence_tpu_torch.datagen.perfect_perception import PerfectPerceptionGenerator
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.ops import homography
from objectpermanence_tpu_torch.train.loop import training_main
from torch_lane import one_torch_thread  # noqa: F401

pytest.importorskip("cv2")

SCENES = [  # seed, frames, objects, snitch_bias, camera_motion
    (0, 60, 6, 0.0, False), (7, 90, 5, 0.7, False), (123, 90, 5, 0.0, True),
    (2024, 300, 8, 0.5, False)]


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("seed,frames,objects,bias,camera", SCENES)
def test_scene_and_boxes_equal_jax(seed, frames, objects, bias, camera):
    ours = simulator.SceneSimulator(seed, frames, objects, snitch_bias=bias, camera_motion=camera)
    theirs = jax_simulator.SceneSimulator(seed, frames, objects, snitch_bias=bias,
                                          camera_motion=camera)
    objs, movements = ours.build()
    jax_objs, jax_movements = theirs.build()
    assert json.dumps(ours.scene_json(objs, movements)) == json.dumps(
        theirs.scene_json(jax_objs, jax_movements))
    assert json.dumps(ours.gt_bb_json(objs)) == json.dumps(theirs.gt_bb_json(jax_objs))
    assert simulator.scene_has_snitch_containment(movements) == \
        jax_simulator.scene_has_snitch_containment(jax_movements)


@pytest.fixture(scope="module")
def simulated(tmp_path_factory):
    root = tmp_path_factory.mktemp("sim")
    for tag, module in (("port", simulator), ("jax", jax_simulator)):
        module.simulate_dataset(root / tag, num_videos=4, seed=11, num_frames=60)
    return root


def test_simulate_dataset_equals_jax(simulated):
    ours, theirs = _files(simulated / "port"), _files(simulated / "jax")
    assert sorted(ours) == sorted(theirs) and len(ours) == 8
    assert ours == theirs


def test_annotation_and_task_files_equal_jax(simulated, tmp_path):
    scenes = simulated / "port" / "scenes"
    for tag, labels, tasks in (("port", scene_labels, cater_tasks),
                               ("jax", jax_scene_labels, jax_cater_tasks)):
        labels.write_annotation_files(scenes, tmp_path / tag / "ann")
        tasks.write_task_labels(scenes, tmp_path / tag / "lists", seed=3)
    ours, theirs = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs) and len(ours) > 10
    assert ours == theirs
    assert any(line.split("\t")[1] for line in
               (tmp_path / "port" / "ann" / "containment_annotations.txt").read_text().splitlines())


@pytest.mark.parametrize("seed,frames,objects,bias,camera", SCENES[:3])
def test_render_video_equals_jax(seed, frames, objects, bias, camera):
    sim = simulator.SceneSimulator(seed, frames, objects, snitch_bias=bias, camera_motion=camera)
    objs, movements = sim.build()
    scene, gt = sim.scene_json(objs, movements), sim.gt_bb_json(objs)
    ours, ours_ann = renderer.render_video(scene, gt, frames)
    theirs, theirs_ann = jax_renderer.render_video(scene, gt, frames)
    np.testing.assert_array_equal(ours, theirs)
    for a, b in zip(ours_ann, theirs_ann):
        np.testing.assert_array_equal(a["bb"], b["bb"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert len(np.unique(ours[0].reshape(-1, 3), axis=0)) > 3


@pytest.mark.parametrize("frames_only", [False, True])
def test_render_dataset_equals_jax(simulated, tmp_path, frames_only):
    scenes, labels = simulated / "port" / "scenes", simulated / "port" / "labels"
    ours = renderer.render_dataset(scenes, labels, tmp_path / "port",
                                   detection_samples_per_video=3, seed=4, frames_only=frames_only)
    theirs = jax_renderer.render_dataset(scenes, labels, tmp_path / "jax",
                                         detection_samples_per_video=3, seed=4,
                                         frames_only=frames_only)
    assert ours[2].read_bytes() == theirs[2].read_bytes()              # the CSV
    rows = sorted(p.name for p in ours[1].glob("*.rows"))
    assert rows == sorted(p.name for p in theirs[1].glob("*.rows")) and len(rows) == 4
    for name in rows:
        assert (ours[1] / name).read_bytes() == (theirs[1] / name).read_bytes()
    pngs = sorted(p.name for p in ours[1].glob("*.png"))
    assert pngs == sorted(p.name for p in theirs[1].glob("*.png")) and len(pngs) == 12
    for name in pngs:
        assert (ours[1] / name).read_bytes() == (theirs[1] / name).read_bytes(), name
    assert ours[0].exists() != frames_only
    if not frames_only:
        videos = sorted(p.name for p in ours[0].glob("*.avi"))
        assert videos == sorted(p.name for p in theirs[0].glob("*.avi")) and len(videos) == 4
        for name in videos:
            assert (ours[0] / name).read_bytes() == (theirs[0] / name).read_bytes()


def test_render_dataset_without_a_video_writer(simulated, tmp_path, monkeypatch):
    """Where cv2 is missing the writer is replaced by one that writes
    nothing; the detection set is the same."""
    scenes, labels = simulated / "port" / "scenes", simulated / "port" / "labels"
    full = renderer.render_dataset(scenes, labels, tmp_path / "full",
                                   detection_samples_per_video=2, seed=1)
    monkeypatch.setattr(renderer, "open_video_writer", lambda *args: None)
    bare = renderer.render_dataset(scenes, labels, tmp_path / "bare",
                                   detection_samples_per_video=2, seed=1)
    assert not list(bare[0].glob("*.avi")) and len(list(full[0].glob("*.avi"))) == 4
    assert bare[2].read_bytes() == full[2].read_bytes()
    for png in full[1].glob("*.png"):
        assert (bare[1] / png.name).read_bytes() == png.read_bytes()


SHAPES = ("sphere", "cone", "spl", "cylinder", "cube")


@pytest.mark.parametrize("shape", SHAPES)
def test_draw_object_equals_jax(shape):
    """Each primitive on 300 random boxes, partly or far outside the frame,
    painted over one frame as the renderer does."""
    rng = np.random.RandomState(SHAPES.index(shape))
    ours = np.full((240, 320, 3), renderer.BACKGROUND, np.uint8)
    theirs = ours.copy()
    for _ in range(300):
        box = (rng.uniform(-40, 360), rng.uniform(-40, 280), rng.uniform(0, 200),
               rng.uniform(0, 160))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        renderer._draw_object(ours, box, shape, color)
        jax_renderer._draw_object(theirs, box, shape, color)
        np.testing.assert_array_equal(ours, theirs, err_msg=str(box))
    assert len(np.unique(ours.reshape(-1, 3), axis=0)) > 20


def test_camera_helpers_equal_jax():
    np.testing.assert_array_equal(homography.camera_center(), jax_homography.camera_center())
    for location in ([0.0, 0.0, 10.0], [-10.0, 6.0, 8.0], homography.camera_center()):
        cam = homography.camera_matrix_at(location)
        np.testing.assert_array_equal(cam, jax_homography.camera_matrix_at(location))
        pts = np.random.RandomState(1).uniform(-3, 3, (20, 3))
        np.testing.assert_array_equal(homography.project_3d_point(pts, cam=cam),
                                      jax_homography.project_3d_point(pts, cam=cam))
    np.testing.assert_allclose(homography.camera_matrix_at(homography.camera_center()),
                               homography.CATER_CAM, atol=1e-9)


def test_simulate_ingest_train_pipeline(simulated, tmp_path):
    """Simulated scenes -> perfect perception -> annotations -> the native
    ingest -> one epoch of `training_main` on the CPU."""
    root = simulated / "port"
    written = {}
    for tag, generator in (("port", PerfectPerceptionGenerator), ("jax", JaxPerfectPerception)):
        written[tag] = generator(root / "scenes", root / "labels", tmp_path / tag / "perception",
                                 visible_ratio=0.99, mode="visible_only").generate()
    assert len(written["port"]) == len(written["jax"]) == 4
    for pkl in sorted((tmp_path / "port" / "perception").glob("*.pkl")):
        ours = pickle.loads(pkl.read_bytes())
        theirs = pickle.loads((tmp_path / "jax" / "perception" / pkl.name).read_bytes())
        for key in ("bb", "labels"):
            assert len(ours[key]) == len(theirs[key]) == 60
            for a, b in zip(ours[key], theirs[key]):
                np.testing.assert_array_equal(a, b)
    ann = scene_labels.write_annotation_files(root / "scenes", tmp_path / "ann")

    dataset = ingest_directory(tmp_path / "port" / "perception", root / "labels", 6,
                               containment_file=ann["containment"])
    jax_dataset = jax_ingest_directory(tmp_path / "jax" / "perception", root / "labels", 6,
                                       containment_file=ann["containment"])
    for key in ("boxes", "index_to_track", "labels", "containment_mask"):
        np.testing.assert_array_equal(getattr(dataset, key), getattr(jax_dataset, key))
    assert dataset.boxes.shape == (4, 60, 15, 6)
    assert (dataset.boxes[:, :, 0, 4] == 0).any()   # the snitch hidden while contained

    torch.manual_seed(0)
    cfg = {"batch_size": 4, "inference_batch_size": 4, "num_epochs": 1, "print_step": 10,
           "learning_rate": 1e-3, "checkpoints_path": str(tmp_path / "ckpt"), "device": "cpu",
           "train_sample_dir": "x", "train_labels_dir": "x", "train_containment_file": "x",
           "dev_sample_dir": "x", "dev_labels_dir": "x", "dev_containment_file": "x"}
    model_cfg = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 32,
                 "videos_hidden_dim": 48}
    result = training_main(get_model_spec("opnet"), dataset, dataset, cfg, model_cfg)
    assert np.isfinite(result.history[0]["train"]["loss"])
