"""The port's programmed models (`models/heuristic.py`, `infer/trackers.py`)
against the JAX package's on the CPU, on fixture data made from a seed.

- The heuristic: every frame's state and box exactly equal; through the CLI
  (`python -m objectpermanence_tpu_torch inference --model_type
  detector_heuristic` against JAX's `main.py`), `_bb.json` byte for byte.
- `skip_existing`, `sample_file`, `labels_dir` and the `_results.avi` debug
  overlay: the same files and decoded frames as JAX's `trackers_inference_main`
  writes.
- `detector_tracker` through both packages' `trackers_inference_main` on a
  written video with the same calibrated seeded weights (a `.pth` both
  load): each box within 1 px of JAX's on at most 1% of the coordinates
  (the network's last-bit gap moves the tracked floats by hundredths of a
  pixel, which can carry an `int()` across an integer), and the same debug
  video frames wherever the boxes agree.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from objectpermanence_tpu.infer import trackers as jax_trackers
from objectpermanence_tpu.models import heuristic as jax_heuristic
from objectpermanence_tpu.train import siam_loop as jax_loop
from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene, write_fixture_dataset
from objectpermanence_tpu_torch.infer import trackers
from objectpermanence_tpu_torch.models import heuristic
from objectpermanence_tpu_torch.models.convert import siam_params_from_jax
from objectpermanence_tpu_torch.vocab import large_cone_indices
from torch_lane import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parent.parent
VIDEOS, SEED = 4, 5
TRACK_FRAMES = 60
PX_SHARE = 1e-2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("trackers")
    pred_dir, labels_dir, _ = write_fixture_dataset(root / "data", num_videos=VIDEOS, seed=SEED)
    return root, pred_dir, labels_dir


def load(pred_dir, index):
    with open(pred_dir / f"CATER_fixture_{index:06d}.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("index", range(VIDEOS))
def test_heuristic_states_equal_jax(data, index):
    _, pred_dir, _ = data
    dets = load(pred_dir, index)
    ours, want = heuristic.HeuristicReasoner(), jax_heuristic.HeuristicReasoner()
    for t in range(len(dets["bb"])):
        ours.track_for_frame(None, t, dets)
        want.track_for_frame(None, t, dets)
        assert ours.snitch_visible == want.snitch_visible and ours.stack == want.stack
        assert ours.state.keys() == want.state.keys()
        for key, value in want.state.items():
            assert np.array_equal(np.asarray(ours.state[key]), np.asarray(value)), (t, key)
        assert trackers._reasoner_box(ours) == jax_trackers._reasoner_box(want)
    assert trackers.track_video(heuristic.HeuristicReasoner(), dets) == jax_trackers.track_video(
        jax_heuristic.HeuristicReasoner(), dets)


def test_get_label_bb_and_cone_shift_match_jax():
    frame = {"bb": np.array([[10.0, 20.0, 31.0, 45.0], [5.0, 5.0, 9.0, 8.0]], np.float32),
             "labels": np.array([140, 3])}
    for label in (140, 3, 77):
        assert heuristic.get_label_bb(frame, label) == jax_heuristic.get_label_bb(frame, label)
    from objectpermanence_tpu.vocab import large_cone_indices as jax_large_cones
    assert large_cone_indices() == jax_large_cones() and len(large_cone_indices()) == 16
    for label in (large_cone_indices()[0], 140, 3):
        ours, want = heuristic.HeuristicReasoner(), jax_heuristic.HeuristicReasoner()
        for r in (ours, want):
            r.state.update(target_pos=(100, 80), target_sz=(30, 40), object_sz=(16, 14),
                           object_label=label)
        assert trackers._reasoner_box(ours) == jax_trackers._reasoner_box(want)


def test_cli_heuristic_bb_json_byte_for_byte(data, tmp_path):
    _, pred_dir, labels_dir = data
    config = tmp_path / "inference.json"
    config.write_text(json.dumps({"sample_dir": str(pred_dir), "labels_dir": str(labels_dir)}))
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": "", **ONE_THREAD_ENV}
    proc = subprocess.run([sys.executable, "-m", "objectpermanence_tpu_torch", "inference",
                           "--model_type", "detector_heuristic", "--results_dir",
                           str(tmp_path / "port"), "--inference_config", str(config)],
                          capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr
    import main as jax_main
    jax_main.main(["inference", "--model_type", "detector_heuristic", "--results_dir",
                   str(tmp_path / "jax"), "--inference_config", str(config)])
    ours = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert ours == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(ours) == VIDEOS
    for name in ours:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_skip_existing_reuses_valid_and_retracks_the_rest(data, tmp_path):
    """A valid earlier file is reused as it is; a short, a corrupt and a
    foreign one are tracked again, by both packages alike."""
    _, pred_dir, _ = data
    config = {"sample_dir": str(pred_dir), "skip_existing": True}
    for tag, module in (("port", trackers), ("jax", jax_trackers)):
        out = tmp_path / tag
        out.mkdir()
        (out / "CATER_fixture_000000_bb.json").write_text(json.dumps([[1, 2, 3, 4]] * 300))
        (out / "CATER_fixture_000001_bb.json").write_text(json.dumps([[1, 2, 3, 4]] * 299))
        (out / "CATER_fixture_000002_bb.json").write_text("[[1, 2, 3")
        (out / "CATER_fixture_000003_bb.json").write_text(json.dumps({"a": 1}))
        result = module.trackers_inference_main("detector_heuristic", str(out), config)
        assert result["CATER_fixture_000000"] == [[1, 2, 3, 4]] * 300
        assert all(result[f"CATER_fixture_{i:06d}"] != [[1, 2, 3, 4]] * 300 for i in (1, 2, 3))
    for name in sorted(p.name for p in (tmp_path / "port").iterdir()):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def write_video(path, frames_bgr):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30,
                             (frames_bgr.shape[2], frames_bgr.shape[1]))
    for frame in frames_bgr:
        writer.write(np.ascontiguousarray(frame))
    writer.release()


def decoded(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def test_debug_video_sample_file_and_labels_match_jax(data, tmp_path):
    """The heuristic with `videos_dir`, `labels_dir` (ground truth drawn
    blue) and a `sample_file` of two videos: the same boxes, and debug
    videos whose decoded frames equal JAX's."""
    root, pred_dir, labels_dir = data
    videos = tmp_path / "videos"
    videos.mkdir()
    for v in (1, 3):
        frames = draw_frames(make_scene(SEED * 1000 + v), seed=v)[:60, ..., ::-1]
        write_video(videos / f"CATER_fixture_{v:06d}.avi", frames)
    (tmp_path / "sample.txt").write_text("CATER_fixture_000001.avi\nCATER_fixture_000003\n")
    config = {"sample_dir": str(pred_dir), "labels_dir": str(labels_dir),
              "videos_dir": str(videos), "sample_file": str(tmp_path / "sample.txt")}
    ours = trackers.trackers_inference_main("detector_heuristic", str(tmp_path / "port"), config)
    want = jax_trackers.trackers_inference_main("detector_heuristic", str(tmp_path / "jax"),
                                                config)
    assert ours == want and sorted(ours) == ["CATER_fixture_000001", "CATER_fixture_000003"]
    for v in (1, 3):
        a = decoded(tmp_path / "port" / f"CATER_fixture_{v:06d}_results.avi")
        b = decoded(tmp_path / "jax" / f"CATER_fixture_{v:06d}_results.avi")
        assert a.shape == b.shape and a.shape[0] == 60 and np.array_equal(a, b)


@pytest.fixture(scope="module")
def tracker_weights(tmp_path_factory):
    """Calibrated seeded weights saved as an upstream-style `.pth`, which
    JAX's `build_siam_reasoner` and the port's both load."""
    from objectpermanence_tpu.models import siam as jax_siam
    params = jax_loop.siam_train_init(jax.random.PRNGKey(4))
    frames = draw_frames(make_scene(11, num_frames=8), seed=11)
    z = np.stack([jax_siam.get_subwindow(f, (160, 120), 100, 127, f.mean((0, 1))) for f in frames])
    x = np.stack([jax_siam.get_subwindow(f, (160, 120), 200, 271, f.mean((0, 1))) for f in frames])
    _, _, stats = jax.jit(jax_loop.pair_forward_train)(
        params, z.transpose(0, 3, 1, 2).astype(np.float32),
        x.transpose(0, 3, 1, 2).astype(np.float32))
    for layer, (mean, var) in zip(params["features"], stats):
        layer["bn"]["mean"], layer["bn"]["var"] = mean, var
    path = tmp_path_factory.mktemp("siam") / "SiamRPNVOT.model"
    torch.save(siam_params_from_jax(jax.device_get(params)), path)
    return path


def test_detector_tracker_through_both_packages(tracker_weights, tmp_path):
    scene = make_scene(12, num_frames=TRACK_FRAMES)
    frames = draw_frames(scene, seed=12)[..., ::-1]
    (tmp_path / "samples").mkdir()
    (tmp_path / "videos").mkdir()
    visible = scene["visible"]
    with open(tmp_path / "samples" / "CATER_track_000000.pkl", "wb") as f:
        pickle.dump({"bb": [scene["boxes"][t, visible[t]].astype(np.float32)
                            for t in range(TRACK_FRAMES)],
                     "labels": [scene["classes"][visible[t]].astype(np.int64)
                                for t in range(TRACK_FRAMES)]}, f)
    write_video(tmp_path / "videos" / "CATER_track_000000.avi", frames)
    config = {"sample_dir": str(tmp_path / "samples"), "videos_dir": str(tmp_path / "videos"),
              "model_path": str(tracker_weights), "device": "cpu"}
    ours = trackers.trackers_inference_main("detector_tracker", str(tmp_path / "port"), config)
    want = jax_trackers.trackers_inference_main("detector_tracker", str(tmp_path / "jax"),
                                                config)
    a = np.array(ours["CATER_track_000000"])
    b = np.array(want["CATER_track_000000"])
    diff = np.abs(a - b)
    assert a.shape == (TRACK_FRAMES, 4) and (~visible[:, 0]).sum() >= 20
    assert diff.max() <= 1 and (diff > 0).mean() <= PX_SHARE, diff.max()
    # the boxes move while the snitch is hidden: the network decided them
    hidden = a[~visible[:, 0]]
    assert len(np.unique(hidden, axis=0)) > 3
    va = decoded(tmp_path / "port" / "CATER_track_000000_results.avi")
    vb = decoded(tmp_path / "jax" / "CATER_track_000000_results.avi")
    same = np.flatnonzero((diff == 0).all(axis=1))
    assert va.shape == vb.shape and np.array_equal(va[same], vb[same])


def test_detector_tracker_needs_the_video(data, tmp_path):
    _, pred_dir, _ = data
    config = {"sample_dir": str(pred_dir), "videos_dir": str(tmp_path), "device": "cpu"}
    for module in (trackers, jax_trackers):
        with pytest.raises(FileNotFoundError, match="needs raw video pixels"):
            module.trackers_inference_main("detector_tracker", str(tmp_path / "out"), config)
    with pytest.raises(AttributeError, match="incorrect"):
        trackers.get_tracker_model("detector_kalman")
