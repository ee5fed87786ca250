"""Minimal pixel renderer for simulated scenes (no Blender), the port's copy
of `objectpermanence_tpu/datagen/renderer.py`. cv2 draws the primitives and
writes the PNGs, imported at the first call as in JAX; the videos go through
`open_video_writer`, which a caller without cv2 may replace.

Draws each scene object as a filled 2D primitive (shape-coded silhouette,
color-coded fill) at its projected GT box, respecting containment
(contained objects are hidden) and camera-distance paint order. The output
is NOT photorealistic CATER — it is a self-contained pixel source with
exact GT so the full two-stage pipeline (detector fine-tuning ->
preprocess -> reasoning -> analysis) runs end-to-end from pixels without
external renders. Blender/Cycles remains the production renderer.
"""

import csv
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from objectpermanence_tpu_torch import FRAME_HEIGHT, FRAME_WIDTH
from objectpermanence_tpu_torch.datagen.perfect_perception import (
    class_index_for_track, contained_frame_ranges, instance_track_name, scene_camera_location,
)

COLOR_RGB = {
    "blue": (60, 90, 235), "brown": (130, 80, 40), "cyan": (70, 200, 210),
    "gray": (128, 128, 128), "green": (60, 170, 70), "purple": (150, 60, 180),
    "red": (210, 50, 50), "yellow": (230, 220, 50), "gold": (240, 200, 40),
}

BACKGROUND = (200, 200, 200)


def _draw_object(frame: np.ndarray, box_xywh, shape: str, color_rgb) -> None:
    import cv2

    x, y, w, h = [int(round(v)) for v in box_xywh]
    x2, y2 = x + max(w, 2), y + max(h, 2)
    cx, cy = (x + x2) // 2, (y + y2) // 2
    if shape == "sphere":
        cv2.ellipse(frame, (cx, cy), (max(w // 2, 1), max(h // 2, 1)), 0,
                    0, 360, color_rgb, -1)
    elif shape in ("cone", "spl"):
        pts = np.array([[cx, y], [x, y2], [x2, y2]])
        cv2.fillPoly(frame, [pts], color_rgb)
        if shape == "spl":  # the snitch gets a marker so it is distinctive
            cv2.circle(frame, (cx, cy + (y2 - y) // 4), max((x2 - x) // 6, 1),
                       (255, 255, 255), -1)
    elif shape == "cylinder":
        cv2.rectangle(frame, (x + w // 6, y), (x2 - w // 6, y2), color_rgb, -1)
        cv2.ellipse(frame, (cx, y), (max(w // 3, 1), max(h // 8, 1)), 0,
                    0, 360, tuple(int(c * 0.8) for c in color_rgb), -1)
    else:  # cube
        cv2.rectangle(frame, (x, y), (x2, y2), color_rgb, -1)


def open_video_writer(path, fps: int, width: int, height: int):
    """The video writer (MJPG `.avi`): an object with `write(bgr_frame)` and
    `release()`, or None to write no video. cv2's; replace it where cv2 is
    missing."""
    import cv2

    return cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (width, height))


def _render_frame(scene, gt_bb, contained, objects, tracks, labels, f: int):
    """One frame -> (HxWx3 uint8 RGB, {'bb': (n,4) xyxy, 'labels': (n,)})."""
    frame = np.full((FRAME_HEIGHT, FRAME_WIDTH, 3), BACKGROUND, np.uint8)
    visible = []
    for obj, track, label in zip(objects, tracks, labels):
        spans = contained.get(label, [])
        if any(start <= f <= end for start, end in spans):
            continue  # hidden inside its container
        visible.append((obj, track, label))
    # paint far-from-camera first so near objects occlude; the camera may
    # move per frame (scene camera_motion block)
    cam = scene_camera_location(scene, f)

    def cam_dist(entry):
        loc = entry[0]["locations"][str(f)]
        return -float(np.linalg.norm(cam - np.asarray(loc)))
    visible.sort(key=cam_dist)

    frame_bb, frame_labels = [], []
    for obj, track, label in visible:
        box = gt_bb[track][f]
        _draw_object(frame, box, obj["shape"], COLOR_RGB[obj["color"]])
        frame_bb.append([box[0], box[1], box[0] + box[2], box[1] + box[3]])
        frame_labels.append(label)
    return frame, {"bb": np.asarray(frame_bb, np.float32).reshape(-1, 4),
                   "labels": np.asarray(frame_labels, np.int64)}


def render_video(scene: dict, gt_bb: dict, num_frames: int) -> Tuple[np.ndarray, List[Dict]]:
    """-> (frames (T, H, W, 3) uint8 RGB, per-frame visible annotations
    [{'bb': (n,4) xyxy, 'labels': (n,)}])."""
    contained = contained_frame_ranges(scene)
    objects = scene["objects"]
    tracks = [instance_track_name(o) for o in objects]
    labels = [class_index_for_track(t) for t in tracks]

    frames = np.empty((num_frames, FRAME_HEIGHT, FRAME_WIDTH, 3), np.uint8)
    annotations = []
    for f in range(num_frames):
        frames[f], ann = _render_frame(scene, gt_bb, contained, objects,
                                       tracks, labels, f)
        annotations.append(ann)
    return frames, annotations


def render_dataset(scenes_dir, labels_dir, output_root, *, fps: int = 24,
                   detection_samples_per_video: int = 4,
                   seed: int = 0, progress_every: int = 0,
                   frames_only: bool = False) -> Tuple[Path, Path, Path]:
    """Render every simulated scene to an .avi (+1 spare frame for the cv2
    extra-frame convention) and emit a detection training set (sampled
    frames as PNG + the reference CSV schema).

    Resumable: each finished video leaves `<name>.avi` + a `.rows` sidecar
    with its CSV rows; both present -> the video is skipped on a re-run.
    Frame sampling is seeded per-video (seed ^ hash(name)) so resumed and
    fresh runs produce identical detection sets. The final CSV is rebuilt
    from the sidecars every call.

    frames_only=True skips the videos entirely and renders ONLY the sampled
    detection frames (~num_frames/k less work) — for detector-training
    experiments that never consume the videos. The sampled frame set is
    identical to a full render with the same seed.
    Returns (videos_dir, det_images_dir, det_csv_path)."""
    import json

    import cv2

    scenes_dir, labels_dir = Path(scenes_dir), Path(labels_dir)
    output_root = Path(output_root)
    videos_dir = output_root / "videos"
    det_dir = output_root / "det_images"
    if not frames_only:
        videos_dir.mkdir(parents=True, exist_ok=True)
    det_dir.mkdir(parents=True, exist_ok=True)

    scene_paths = sorted(scenes_dir.glob("*.json"))
    for i, scene_path in enumerate(scene_paths):
        name = scene_path.stem
        avi_path = videos_dir / f"{name}.avi"
        rows_path = det_dir / f"{name}.rows"
        if rows_path.exists() and (frames_only or avi_path.exists()):
            continue
        with open(scene_path) as f:
            scene = json.load(f)
        with open(labels_dir / f"{name}_bb.json") as f:
            gt_bb = json.load(f)
        num_frames = len(next(iter(gt_bb.values())))

        rng = np.random.RandomState(
            (seed * 1000003 + int.from_bytes(name.encode()[-8:], "little")) % (2**31))
        k = min(detection_samples_per_video, num_frames)
        sampled = rng.choice(num_frames, k, replace=False)

        if frames_only:
            contained = contained_frame_ranges(scene)
            objects = scene["objects"]
            tracks = [instance_track_name(o) for o in objects]
            labels = [class_index_for_track(t) for t in tracks]
            frames, annotations = {}, {}
            for f in sampled:
                frames[f], annotations[f] = _render_frame(
                    scene, gt_bb, contained, objects, tracks, labels, int(f))
        else:
            all_frames, all_annotations = render_video(scene, gt_bb, num_frames)
            frames = {f: all_frames[f] for f in sampled}
            annotations = {f: all_annotations[f] for f in sampled}

            tmp_path = videos_dir / f"{name}.avi.tmp.avi"  # keep .avi suffix for cv2
            writer = open_video_writer(tmp_path, fps, FRAME_WIDTH, FRAME_HEIGHT)
            if writer is not None:
                for f in range(num_frames):
                    writer.write(np.ascontiguousarray(all_frames[f][..., ::-1]))
                writer.write(np.ascontiguousarray(all_frames[-1][..., ::-1]))  # spare frame
                writer.release()
                tmp_path.rename(avi_path)

        csv_rows = []
        for f in sampled:
            img_name = f"{name}_f{f:04d}.png"
            cv2.imwrite(str(det_dir / img_name), cv2.cvtColor(frames[f], cv2.COLOR_RGB2BGR))
            ann = annotations[f]
            for bb, label in zip(ann["bb"], ann["labels"]):
                csv_rows.append([img_name, int(label), float(bb[0]), float(bb[1]),
                                 float(bb[2] - bb[0]), float(bb[3] - bb[1])])
        with open(rows_path, "w", newline="") as f:
            csv.writer(f).writerows(csv_rows)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"[render] {i + 1}/{len(scene_paths)} videos", flush=True)

    csv_path = output_root / "detection_annotations.csv"
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["filename", "object_class", "X", "Y", "width", "height"])
        for scene_path in scene_paths:
            rows_path = det_dir / f"{scene_path.stem}.rows"
            with open(rows_path, newline="") as rf:
                writer.writerows(csv.reader(rf))
    return videos_dir, det_dir, csv_path
