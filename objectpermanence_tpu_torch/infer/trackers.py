"""Programmed-model (frame-sequential) inference, the counterpart of
`objectpermanence_tpu/infer/trackers.py`: `inference --model_type
detector_heuristic | detector_tracker`.

Reference `baselines/inference_main.py:44-159`: per video, walk the frames,
call the stateful reasoner, draw the debug boxes, and write the
`<name>_bb.json` predictions. The heuristic needs no pixels and runs no
device code, so videos are optional for it; `detector_tracker` reads the
frames and runs SiamRPN on `device` (the card unless the config says
`"device": "cpu"`) for every frame in which the snitch is hidden.

Frames are read by `read_video_bgr` and debug videos written through
`open_debug_writer`, module-level functions that import cv2 at their first
call (so the package imports without it) and that a caller without cv2 may
replace.
"""

import json
import pickle
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from objectpermanence_tpu_torch import VIDEO_NUM_FRAMES, resolve_device
from objectpermanence_tpu_torch.analysis.analyzer import write_bb_predictions
from objectpermanence_tpu_torch.config import config_device
from objectpermanence_tpu_torch.models.heuristic import AbstractReasoner, HeuristicReasoner
from objectpermanence_tpu_torch.vocab import large_cone_indices

LARGE_CONE_IDS = set(large_cone_indices())


def read_video_bgr(video_path) -> np.ndarray:
    """Every frame cv2 decodes of `video_path`, (T, H, W, 3) uint8 BGR, as
    the reference's tracker reads them (no colour conversion)."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, 240, 320, 3), np.uint8)


def open_debug_writer(path, width: int, height: int):
    """The `_results.avi` writer (mp4v, 30 fps): an object with `write(frame)`
    and `release()`, or None to draw nothing."""
    import cv2

    return cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (width, height))


def get_tracker_model(model_type: str, model_weights: str = "", device=None) -> AbstractReasoner:
    """A fresh reasoner of `model_type` (reference `models_factory.py:16-33`);
    `detector_tracker`'s network from `model_weights`, on `device`."""
    if model_type == "detector_heuristic":
        return HeuristicReasoner()
    if model_type == "detector_tracker":
        from objectpermanence_tpu_torch.models.siam import build_siam_reasoner
        return build_siam_reasoner(model_weights, device=device)
    raise AttributeError(f"Tracking model name is incorrect: {model_type!r}")


def _reasoner_box(reasoner: AbstractReasoner) -> List[int]:
    """The current prediction box by the reference's rules
    (`inference_main.py:82-122`): a seen snitch -> the detector's box; hidden
    with a known snitch size -> a snitch-sized box at the carrier's position
    (15 px lower under a large cone); else the carrier's box."""
    state = reasoner.state
    if reasoner.snitch_visible:
        return [int(v) for v in state["snitch_box"]]
    cx, cy = state["target_pos"]
    if "object_sz" in state:
        w, h = state["object_sz"]
        if state.get("object_label") in LARGE_CONE_IDS:
            cy = cy + 15
    else:
        w, h = state["target_sz"]
    return [int(cx - w / 2), int(cy - h / 2), int(cx + w / 2), int(cy + h / 2)]


def track_video(reasoner: AbstractReasoner, prediction_data: Dict,
                num_frames: int = VIDEO_NUM_FRAMES, frames_reader=None, debug_writer=None,
                gt_boxes=None) -> List[List[int]]:
    """Run the stateful reasoner over one video's detections; with a debug
    writer, draw the reference's overlay on each frame (the tracked box
    yellow, the ground truth blue, the carried object's box red:
    `inference_main.py:82-114`)."""
    predictions = []
    for frame_idx in range(num_frames):
        frame = frames_reader(frame_idx) if frames_reader is not None else None
        reasoner.track_for_frame(frame, frame_idx, prediction_data)
        box = _reasoner_box(reasoner)
        predictions.append(box)

        if debug_writer is not None and frame is not None:
            import cv2
            state = reasoner.state
            if reasoner.snitch_visible:
                tracked = [int(v) for v in state["snitch_box"]]
            else:
                cx, cy = state["target_pos"]
                w, h = state["target_sz"]
                tracked = [int(cx - w / 2), int(cy - h / 2), int(cx + w / 2), int(cy + h / 2)]
            canvas = np.ascontiguousarray(frame)
            cv2.rectangle(canvas, (tracked[0], tracked[1]), (tracked[2], tracked[3]),
                          (0, 255, 255), 3)
            if gt_boxes is not None:
                g = [int(v) for v in gt_boxes[frame_idx]]
                cv2.rectangle(canvas, (g[0], g[1]), (g[2], g[3]), (255, 0, 0), 3)
            if "object_sz" in state and not reasoner.snitch_visible:
                cv2.rectangle(canvas, (box[0], box[1]), (box[2], box[3]), (0, 0, 255), 3)
            debug_writer.write(canvas)
    return predictions


def _reusable(done_path: Path, num_frames: int) -> Optional[list]:
    """The boxes of an earlier `<name>_bb.json`, or None when it is corrupt,
    short or foreign (a crashed writer, stale results of another set)."""
    try:
        with open(done_path) as f:
            prev = json.load(f)
    except (json.JSONDecodeError, OSError):
        return None
    if (isinstance(prev, list) and len(prev) == num_frames
            and all(isinstance(b, list) and len(b) == 4 for b in prev)):
        return prev
    return None


def trackers_inference_main(model_type: str, results_dir: str, config: Dict,
                            device=None) -> Dict[str, List[List[int]]]:
    """Track every `<name>.pkl` of `config["sample_dir"]` (those named in
    `sample_file`, if given) and write `<name>_bb.json` to `results_dir`.
    With `videos_dir`, each video's frames feed the reasoner and its overlay
    goes to `<name>_results.avi` (with `labels_dir`'s ground truth drawn);
    `detector_tracker` raises FileNotFoundError without its video. With
    `skip_existing`, a valid earlier `<name>_bb.json` is reused instead of
    tracking again. `detector_tracker` runs on `device`, by default the
    config's (`"cpu"`, else the card; raises without one)."""
    samples_dir = Path(config["sample_dir"])
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    model_weights = config.get("model_path") or ""
    skip_existing = bool(config.get("skip_existing", False))
    tracker = None
    if model_type == "detector_tracker":
        from objectpermanence_tpu_torch.models.siam import (
            ObjectDetectWithSiamTracker, SiamRPNTracker, load_siam_model,
        )
        device = resolve_device(config_device(config.get("device", "")) if device is None
                                else device)
        # one network for every video; each video's reasoner holds its own state
        tracker = SiamRPNTracker(load_siam_model(model_weights), device=device)

    videos_dir = config.get("videos_dir")
    sample_file = config.get("sample_file")
    names = sorted(p.stem for p in samples_dir.glob("*.pkl"))
    if sample_file:
        with open(sample_file) as f:
            wanted = {Path(line.strip()).stem for line in f if line.strip()}
        names = [n for n in names if n in wanted]
    labels_dir = config.get("labels_dir")

    all_predictions = {}
    for name in names:
        with open(samples_dir / f"{name}.pkl", "rb") as f:
            prediction_data = pickle.load(f)
        num_frames = len(prediction_data["bb"])

        done_path = results_dir / f"{name}_bb.json"
        if skip_existing and done_path.exists():
            prev = _reusable(done_path, num_frames)
            if prev is not None:
                all_predictions[name] = prev
                continue

        frames_reader = debug_writer = gt_boxes = None
        video_path = Path(videos_dir) / f"{name}.avi" if videos_dir else None
        if video_path is not None and video_path.exists():
            frames = read_video_bgr(video_path)

            def frames_reader(idx, _frames=frames):
                return _frames[idx] if idx < len(_frames) else None

            height, width = frames.shape[1:3]
            debug_writer = open_debug_writer(results_dir / f"{name}_results.avi", width, height)
            if labels_dir:
                from objectpermanence_tpu_torch.analysis.analyzer import parse_gt_bb_json
                gt_path = Path(labels_dir) / f"{name}_bb.json"
                if gt_path.exists():
                    gt_boxes = parse_gt_bb_json(gt_path)
        elif model_type == "detector_tracker":
            raise FileNotFoundError(
                f"detector_tracker needs raw video pixels; missing {video_path}")

        reasoner = (ObjectDetectWithSiamTracker(tracker) if tracker is not None
                    else get_tracker_model(model_type))
        predictions = track_video(reasoner, prediction_data, num_frames, frames_reader,
                                  debug_writer, gt_boxes)
        if debug_writer is not None:
            debug_writer.release()
        write_bb_predictions(name, results_dir, predictions)
        all_predictions[name] = predictions
    return all_predictions
