"""The port's cv2 debug and validation tools against the JAX package's, on
the CPU with cv2: `infer/reasoning.py::write_debug_video` and the debug
videos of `reasoning_inference_main` (with `sample_file`),
`utils/video_checks.py` and `infer/detector_tools.py`. Every output is held
exactly equal to JAX's: the same pixels drawn, the same files written, the
same frame counts.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from objectpermanence_tpu.infer import detector_tools as jax_detector_tools
from objectpermanence_tpu.infer.reasoning import write_debug_video as jax_write_debug_video
from objectpermanence_tpu.utils import video_checks as jax_video_checks
from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene, write_fixture_dataset
from objectpermanence_tpu_torch.infer import detector_tools
from objectpermanence_tpu_torch.infer.reasoning import reasoning_inference_main, write_debug_video
from objectpermanence_tpu_torch.utils import video_checks
from torch_lane import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")


def write_video(path, frames_bgr, fourcc="MJPG"):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30,
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
    return np.stack(frames) if frames else np.zeros((0,))


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    frames = draw_frames(make_scene(3, num_frames=31), seed=3)[..., ::-1]
    write_video(root / "CATER_fixture_000000.avi", frames)
    return root / "CATER_fixture_000000.avi", frames


def test_write_debug_video_matches_jax(video, tmp_path):
    path, _ = video
    rng = np.random.RandomState(0)
    predictions = rng.randint(0, 300, (30, 4)).astype(np.int32)
    labels = rng.randint(0, 300, (30, 4)).astype(np.int32)
    write_debug_video(path, tmp_path / "ours.avi", predictions, labels)
    jax_write_debug_video(path, tmp_path / "jax.avi", predictions, labels)
    ours, want = decoded(tmp_path / "ours.avi"), decoded(tmp_path / "jax.avi")
    # cv2 counts one spurious extra frame; the last one is not drawn
    assert ours.shape == want.shape and len(ours) == 30 and np.array_equal(ours, want)
    with pytest.raises(RuntimeError, match="Unable to open"):
        write_debug_video(tmp_path / "missing.avi", tmp_path / "x.avi", predictions, labels)


def test_reasoning_inference_debug_videos_follow_sample_file(tmp_path):
    """`videos_dir` gives each sampled video a `_results.avi` of its boxes
    and ground truth, the same video `write_debug_video` draws from them."""
    pred, labels, _ = write_fixture_dataset(tmp_path / "data", num_videos=3, seed=2,
                                            num_frames=40)
    videos = tmp_path / "videos"
    videos.mkdir()
    for v in range(3):
        frames = draw_frames(make_scene(2000 + v, num_frames=41), seed=v)[..., ::-1]
        write_video(videos / f"CATER_fixture_{v:06d}.avi", frames)
    (tmp_path / "sample.txt").write_text("CATER_fixture_000002.avi\n")
    config = {"sample_dir": str(pred), "labels_dir": str(labels), "device": "cpu",
              "videos_dir": str(videos), "sample_file": str(tmp_path / "sample.txt")}
    model = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
             "videos_hidden_dim": 24}
    preds = reasoning_inference_main("opnet", str(tmp_path / "out"), config, model)
    assert sorted(p.name for p in (tmp_path / "out").glob("*.avi")) == [
        "CATER_fixture_000002_results.avi"]
    gt = json.loads((labels / "CATER_fixture_000002_bb.json").read_text())
    track = np.asarray(gt["small_gold_spl_metal_Spl_0"], np.float64)
    gt_px = np.column_stack([track[:, :2], track[:, :2] + track[:, 2:]]) / [320, 240, 320, 240]
    gt_px = (gt_px.astype(np.float32) * np.float32([320, 240, 320, 240])).astype(np.int32)
    jax_write_debug_video(videos / "CATER_fixture_000002.avi", tmp_path / "jax.avi",
                          preds["CATER_fixture_000002"], gt_px)
    ours = decoded(tmp_path / "out" / "CATER_fixture_000002_results.avi")
    assert len(ours) == 40 and np.array_equal(ours, decoded(tmp_path / "jax.avi"))


def test_find_broken_videos_matches_jax(tmp_path, video):
    _, frames = video
    write_video(tmp_path / "good.avi", np.concatenate([frames] * 10)[:301])
    write_video(tmp_path / "short.avi", frames[:10])
    (tmp_path / "corrupt.avi").write_bytes(b"not a video")
    ours = video_checks.find_broken_videos(tmp_path)
    assert ours == jax_video_checks.find_broken_videos(tmp_path)
    assert set(ours) == {"short", "corrupt"} and ours["corrupt"] in (-1, 0)
    assert video_checks.video_frame_count(tmp_path / "good.avi") == 301


def test_draw_and_save_detections_match_jax(video, tmp_path):
    _, frames = video
    image = np.ascontiguousarray(frames[4])
    boxes = np.array([[10.5, 20.2, 60.0, 80.9], [100.0, 50.0, 140.0, 90.0],
                      [200.0, 10.0, 230.0, 40.0]], np.float32)
    labels = np.array([140, 3, 999])
    valid = np.array([True, True, False])
    for v in (None, valid):
        assert np.array_equal(detector_tools.draw_detections(image, boxes, labels, v),
                              jax_detector_tools.draw_detections(image, boxes, labels, v))
    detector_tools.save_detector_output(tmp_path / "ours.png", image, boxes, labels, valid)
    jax_detector_tools.save_detector_output(tmp_path / "jax.png", image, boxes, labels, valid)
    assert np.array_equal(cv2.imread(str(tmp_path / "ours.png")),
                          cv2.imread(str(tmp_path / "jax.png")))


class _Detector:
    """Stands in for the detector: the snitch (140) at score 0.9 on frames
    2-5, at 0.5 on frame 7, never after; each image's call returns 4
    padded detections."""

    def __call__(self, images):
        n = len(images)
        boxes = np.tile(np.array([[5.0, 5.0, 40.0, 30.0]], np.float32), (n, 4, 1))
        labels = np.tile(np.array([3, 140, 7, 0]), (n, 1))
        scores = np.full((n, 4), 0.95, np.float32)
        return boxes, labels, scores, np.tile(np.array([True, True, True, False]), (n, 1))

    def detect_video(self, frames, batch_size=16):
        boxes, labels, scores, valid = self(frames)
        scores[:, 1] = 0.1
        scores[2:6, 1] = 0.9
        scores[7, 1] = 0.5
        return boxes, labels, scores, valid


def test_detector_tools_with_a_detector_match_jax(video, tmp_path):
    path, frames = video
    ours = detector_tools.get_last_frame_with_object(_Detector(), 140, path)
    want = jax_detector_tools.get_last_frame_with_object(_Detector(), 140, path)
    assert ours == want == (6, 30)
    assert detector_tools.get_last_frame_with_object(_Detector(), 140, path,
                                                     score_threshold=0.4) == (8, 30)
    images = frames[:3, ..., ::-1]
    written = detector_tools.spot_check_detections(_Detector(), images, tmp_path / "ours")
    jax_written = jax_detector_tools.spot_check_detections(_Detector(), images, tmp_path / "jax")
    assert [Path(p).name for p in written] == [Path(p).name for p in jax_written] == [
        "val_000.png", "val_001.png", "val_002.png"]
    for a, b in zip(written, jax_written):
        assert np.array_equal(cv2.imread(str(a)), cv2.imread(str(b)))
