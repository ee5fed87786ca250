"""Detector host utilities, the counterpart of
`objectpermanence_tpu/infer/detector_tools.py`: drawing detections and the
last frame an object is seen in.

Ports of `baselines/detector.py:88-158` (`save_detector_output`,
`get_last_frame_detector_predict_object`) and the spot-check scripts
`object_detection/val_trained_model.py` and `check_dataset.py`. cv2 is
imported inside the functions that draw or write, so the package imports
without it. `detector` is a `models.detector.CaterDetector`.
"""

from pathlib import Path
from typing import Tuple

import numpy as np

from objectpermanence_tpu_torch.vocab import OBJECTS_IDX_TO_NAME


def draw_detections(image_bgr: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                    valid=None) -> np.ndarray:
    """Labelled detection boxes on a copy of the image (reference
    `save_detector_output`)."""
    import cv2

    out = image_bgr.copy()
    for i in range(len(boxes)):
        if valid is not None and not valid[i]:
            continue
        bb = boxes[i].astype(np.int32)
        name = OBJECTS_IDX_TO_NAME.get(int(labels[i]), str(int(labels[i])))
        cv2.rectangle(out, (bb[0], bb[1]), (bb[2], bb[3]), (0, 0, 0), 1)
        cv2.putText(out, name, (bb[0], bb[1] - 10), cv2.FONT_HERSHEY_SIMPLEX,
                    0.3, (36, 255, 12), 1)
    return out


def save_detector_output(save_path, image_bgr, boxes, labels, valid=None) -> None:
    import cv2

    cv2.imwrite(str(save_path), draw_detections(image_bgr, boxes, labels, valid))


def get_last_frame_with_object(detector, object_id: int, video_path,
                               batch_size: int = 24,
                               score_threshold: float = 0.8) -> Tuple[int, int]:
    """The last frame (1-based, the tracker's convention) in which
    `object_id` is detected with a score of at least `score_threshold`, and
    the video's frame count (reference
    `get_last_frame_detector_predict_object`)."""
    from objectpermanence_tpu_torch.infer import preprocess

    frames = preprocess.read_video_frames(video_path)
    boxes, labels, scores, valid = detector.detect_video(frames, batch_size)
    hit = np.any((labels == object_id) & valid & (scores >= score_threshold), axis=1)
    last = int(np.flatnonzero(hit)[-1]) if hit.any() else 0
    return last + 1, len(frames)


def spot_check_detections(detector, images: np.ndarray, output_dir,
                          prefix: str = "val") -> list:
    """Detections of a batch of RGB images drawn to PNGs (reference
    `val_trained_model.py:16-33`)."""
    import cv2

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    boxes, labels, scores, valid = detector(images)
    written = []
    for i, image in enumerate(images):
        bgr = cv2.cvtColor(image.astype(np.uint8), cv2.COLOR_RGB2BGR)
        path = output_dir / f"{prefix}_{i:03d}.png"
        save_detector_output(path, bgr, boxes[i], labels[i], valid[i])
        written.append(path)
    return written
