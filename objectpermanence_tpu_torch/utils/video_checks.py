"""Data validation: broken or corrupt video detection, the counterpart of
`objectpermanence_tpu/utils/video_checks.py`.

Port of `generate/gen_utils.py:24-47` and the ffmpeg frame-count check of
`gen_train_test.py:209-228`, through cv2 (imported at the first call, so
the package imports without it)."""

from pathlib import Path
from typing import Dict


def video_frame_count(video_path) -> int:
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        return -1
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return count


def find_broken_videos(videos_dir, expected_frames: int = 301) -> Dict[str, int]:
    """{video_name: frame_count} of the videos that fail to open or lack
    the expected frame count (301 = 300 and cv2's spurious extra frame)."""
    broken = {}
    for path in sorted(Path(videos_dir).glob("*.avi")):
        count = video_frame_count(path)
        if count != expected_frames:
            broken[path.stem] = count
    return broken
