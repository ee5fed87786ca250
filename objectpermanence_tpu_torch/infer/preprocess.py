"""Perception preprocessing, the counterpart of
`objectpermanence_tpu/infer/preprocess.py`: raw videos -> per-video
detection pickles.

The detector is loaded once; each video is decoded on a host thread while
the previous one runs on the card in chunks of `batch_size` frames; only
detections with score >= 0.8 are kept, in the reference's pickle schema
`{"bb": [float32 (n_f, 4)] * 300, "labels": [int64 (n_f,)] * 300}`.
"""

import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np

from objectpermanence_tpu_torch import VIDEO_NUM_FRAMES, resolve_device
from objectpermanence_tpu_torch.config import config_device, preprocess_config_from

SCORE_THRESHOLD = 0.8


def read_video_frames(video_path) -> np.ndarray:
    """Decode a video to (T, H, W, 3) uint8 RGB, dropping cv2's spurious
    extra frame (`tracking_utils.py:27-30`). cv2 is imported here, at the
    first decode, so the package imports without it."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise RuntimeError(f"Unable to open video {video_path}")
    num_valid = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) - 1
    frames = []
    for _ in range(num_valid):
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames) if frames else np.zeros((0, 240, 320, 3), np.uint8)


def detections_to_lists(boxes: np.ndarray, labels: np.ndarray, scores: np.ndarray,
                        valid: np.ndarray) -> Dict[str, List[np.ndarray]]:
    """Dense padded per-frame detector output -> the reference's ragged
    pickle schema, keeping the score-sorted prefix with score >= 0.8
    (`detector.py:14-28`)."""
    out_bb, out_labels = [], []
    for f in range(len(boxes)):
        keep = valid[f] & (scores[f] >= SCORE_THRESHOLD)
        out_bb.append(boxes[f][keep].astype(np.float32))
        out_labels.append(labels[f][keep].astype(np.int64))
    return {"bb": out_bb, "labels": out_labels}


def preprocess_main(results_dir: str, config: Dict, device=None) -> List[str]:
    """Run the detector over every `<video>.avi` in `config["videos_dir"]`
    (or those named in `sample_file`) and write `<video>.pkl` for each one
    with exactly 300 frames, like the reference's guard
    (`preprocess_perception_main.py:92-96`). Returns the names written.

    Any `DetectorConfig` field may be set in the config (`min_size: 240`,
    `max_size: 320` run native CATER frames; without them, the 800 px
    recipe's geometry; `compute_dtype: "bfloat16"` and `roi_backend:
    "windowed"` give its served configuration); `od_model_weights` is a
    `.npz` or a torchvision `.pth`, or absent for seeded random weights.
    `device` defaults to the config's: "cpu" is the CPU, anything else the
    card. A video that fails to decode, or has another frame count, is
    reported and skipped; a fault of the detector is raised."""
    from objectpermanence_tpu_torch.models.detector.detector import (
        CaterDetector, DetectorConfig,
    )

    cfg, overrides = preprocess_config_from(config)
    device = resolve_device(config_device(cfg.device) if device is None else device)
    det_config = DetectorConfig(**overrides) if overrides else None
    detector = CaterDetector.load(cfg.od_model_weights, det_config, device=device)

    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    video_paths = sorted(Path(cfg.videos_dir).glob("*.avi"))
    if cfg.sample_file:
        # only the listed videos (reference `get_experiment_videos`,
        # `inference_main.py:22-41`)
        with open(cfg.sample_file) as f:
            wanted = {Path(line.strip()).stem for line in f if line.strip()}
        video_paths = [p for p in video_paths if p.stem in wanted]

    def decode(video_path: Path) -> np.ndarray:
        frames = read_video_frames(video_path)
        if len(frames) != VIDEO_NUM_FRAMES:
            raise ValueError(f"{len(frames)} frames, skipping")
        return frames

    # up to `pipeline_depth` videos decode on pool threads while the card
    # runs the current one
    written = []
    ahead = cfg.pipeline_depth
    with ThreadPoolExecutor(ahead) as pool:
        decoding = {}

        def submit(i):
            if i < len(video_paths):
                decoding[i] = pool.submit(decode, video_paths[i])

        for i in range(ahead):
            submit(i)
        for i, video_path in enumerate(video_paths):
            submit(i + ahead)
            try:
                frames = decoding.pop(i).result()
            except Exception as exc:  # per-video isolation, like the reference
                print(f"problem with video {video_path.stem}: {exc}")
                continue
            data = detections_to_lists(*detector.detect_video(frames, cfg.batch_size))
            with open(results_dir / f"{video_path.stem}.pkl", "wb") as f:
                pickle.dump(data, f)
            written.append(video_path.stem)
    return written
