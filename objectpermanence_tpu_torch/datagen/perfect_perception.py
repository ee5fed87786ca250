"""Perfect-perception datasets from ground-truth scene geometry, the port's
copy of `objectpermanence_tpu/datagen/perfect_perception.py`. Host numpy.

Port of `generate/get_perfect_perception_and_visible_snitch_ratio.py`:
perception pickles from scene jsons and GT boxes instead of a detector,
dropping contained objects (`uncontained` mode) and applying a geometric
occlusion test (`visible_only` mode: the bbox overlap ratio and the 3D
distance from the camera decide occluder and occluded). Also writes
snitch-visibility-ratio annotation files. `train/siam_loop.py` reads the
containment spans and track names from here.
"""

import json
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from objectpermanence_tpu_torch.vocab import OBJECTS_NAME_TO_IDX

NUM_FRAMES = 300
SNITCH_INDEX = 140
CAMERA_LOCATION = np.array([7.1146, -6.1746, 5.5963])


def instance_track_name(obj: dict) -> str:
    return "_".join(obj[a] for a in ["size", "color", "shape", "material", "instance"])


def class_index_for_track(track_name: str) -> int:
    """Track key (`size_color_shape_material_Instance_k`) -> class index
    (reference `_cvt_class_to_idx` handles the `_Smooth` suffix variants)."""
    parts = track_name.split("_Smooth")[0].split("_")
    name = "_".join(parts)
    if name in OBJECTS_NAME_TO_IDX:
        return OBJECTS_NAME_TO_IDX[name]
    return OBJECTS_NAME_TO_IDX["_".join(parts[:-2])]


def contained_frame_ranges(scene: dict) -> Dict[int, List[Tuple[int, int]]]:
    """{contained class index: [(start, end)]} for every containment in the
    scene (reference `_get_objects_contained_frames`)."""
    ranges: Dict[int, List[Tuple[int, int]]] = {}
    for obj_name, actions in scene["movements"].items():
        if "Cone" not in obj_name:
            continue
        contain_idx = [i for i, a in enumerate(actions) if "_contain" in a[0]]
        pick_idx = [i for i, a in enumerate(actions) if "_pick_place" in a[0]]
        for c in contain_idx:
            target = actions[c][1]
            later_picks = [p for p in pick_idx if p >= c]
            end = actions[later_picks[0]][2] if later_picks else NUM_FRAMES
            target_class = None
            for obj in scene["objects"]:
                if obj["instance"] == target:
                    target_class = class_index_for_track(instance_track_name(obj))
            if target_class is None:
                continue
            ranges.setdefault(target_class, []).append((actions[c][3], end))
    return ranges


def scene_camera_location(scene: dict, frame: int) -> np.ndarray:
    """Per-frame camera location: the fixed CAMERA_LOCATION unless the
    scene json carries a `camera_motion` block (simulator scenes using the
    reference renderer's optional random camera motion), whose keyframes
    are linearly interpolated. NOTE the reference's own perfect-perception
    tooling hardcodes the camera even for camera-motion renders
    (`get_perfect_perception_and_visible_snitch_ratio.py:198-229`);
    honoring the scene's recorded camera keeps occlusion labels and paint
    order consistent with the projected boxes — a deliberate improvement."""
    cm = scene.get("camera_motion")
    if not cm:
        return CAMERA_LOCATION
    keys = cm["keyframes"]
    for (f0, p0), (f1, p1) in zip(keys, keys[1:]):
        if f0 <= frame <= f1:
            a = 0.0 if f1 == f0 else (frame - f0) / (f1 - f0)
            p0 = np.asarray(p0, dtype=np.float64)
            return p0 + a * (np.asarray(p1, dtype=np.float64) - p0)
    return np.asarray(keys[-1][1], dtype=np.float64)


def occluded_pair(box1_xywh, box2_xywh, coord1, coord2, overlap_thresh: float,
                  camera_location: np.ndarray = None
                  ) -> Optional[Tuple[bool, bool]]:
    """Geometric occlusion test (reference `_check_if_obj_occluded`): if the
    smaller box overlaps the bigger by >= thresh of its own area AND is
    farther from the camera, it is occluded. `camera_location` overrides
    the fixed camera (camera-motion scenes)."""
    def to_xyxy(b):
        return np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]])

    b1, b2 = to_xyxy(box1_xywh), to_xyxy(box2_xywh)
    ix = max(0, min(b1[2], b2[2]) - max(b1[0], b2[0]) + 1)
    iy = max(0, min(b1[3], b2[3]) - max(b1[1], b2[1]) + 1)
    inter = ix * iy
    a1 = (b1[2] - b1[0] + 1) * (b1[3] - b1[1] + 1)
    a2 = (b2[2] - b2[0] + 1) * (b2[3] - b2[1] + 1)
    if inter / min(a1, a2) < overlap_thresh:
        return None
    cam = CAMERA_LOCATION if camera_location is None else camera_location
    d1 = np.linalg.norm(cam - np.asarray(coord1))
    d2 = np.linalg.norm(cam - np.asarray(coord2))
    if a1 < a2 and d1 > d2:
        return (True, False)
    if a2 < a1 and d2 > d1:
        return (False, True)
    return None


class PerfectPerceptionGenerator:
    """Generate per-video perception pickles + visibility annotations from
    scene jsons and GT `<name>_bb.json` boxes."""

    def __init__(self, scenes_dir, labels_dir, output_dir,
                 visible_ratio: float = 0.99, mode: str = "visible_only"):
        if mode not in ("visible_only", "uncontained"):
            raise NotImplementedError(f"perception mode {mode!r} not supported")
        self.scenes_dir = Path(scenes_dir)
        self.labels_dir = Path(labels_dir)
        self.output_dir = Path(output_dir)
        self.visible_ratio = visible_ratio
        self.mode = mode
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def _video_names(self) -> List[str]:
        return sorted(p.stem for p in self.scenes_dir.glob("*.json"))

    def _load(self, name: str):
        with open(self.scenes_dir / f"{name}.json") as f:
            scene = json.load(f)
        with open(self.labels_dir / f"{name}_bb.json") as f:
            gt_bb = json.load(f)
        return scene, gt_bb

    def _scene_frames(self, scene, gt_bb):
        """Dense per-frame (xywh boxes, class labels, 3d coords) for the
        uncontained objects of every frame."""
        contained = contained_frame_ranges(scene)
        tracks = [instance_track_name(obj) for obj in scene["objects"]]
        labels = [class_index_for_track(t) for t in tracks]
        frames = []
        num_frames = min(NUM_FRAMES, min(len(gt_bb[t]) for t in tracks))
        for f in range(num_frames):
            frame_bb, frame_labels, frame_coords = [], [], []
            for track, label, obj in zip(tracks, labels, scene["objects"]):
                spans = contained.get(label, [])
                if any(start <= f <= end for start, end in spans):
                    continue
                frame_bb.append(np.asarray(gt_bb[track][f], dtype=np.float64))
                frame_labels.append(label)
                frame_coords.append(obj["locations"][str(f)])
            frames.append((frame_bb, np.array(frame_labels, dtype=np.int64),
                           frame_coords, scene_camera_location(scene, f)))
        return frames

    def _visible_subset(self, frame_bb, frame_labels, frame_coords, cam):
        occluded = [False] * len(frame_bb)
        thresh = 1 - self.visible_ratio
        for i in range(len(frame_bb)):
            for j in range(i, len(frame_bb)):
                result = occluded_pair(frame_bb[i], frame_bb[j],
                                       frame_coords[i], frame_coords[j],
                                       thresh, camera_location=cam)
                if result is not None:
                    if result[0]:
                        occluded[i] = True
                    else:
                        occluded[j] = True
        keep = [k for k in range(len(frame_bb)) if not occluded[k]]
        return [frame_bb[k] for k in keep], frame_labels[keep]

    def generate(self) -> List[str]:
        """Write `<name>.pkl` per video in the reference perception schema
        (xyxy boxes after the visibility filter)."""
        written = []
        for name in self._video_names():
            scene, gt_bb = self._load(name)
            data = {"bb": [], "labels": []}
            for frame_bb, frame_labels, frame_coords, cam in \
                    self._scene_frames(scene, gt_bb):
                if self.mode == "visible_only":
                    frame_bb, frame_labels = self._visible_subset(
                        frame_bb, frame_labels, frame_coords, cam)
                xyxy = [np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]])
                        for b in frame_bb]
                data["bb"].append(np.asarray(xyxy, dtype=np.float32).reshape(-1, 4))
                data["labels"].append(np.asarray(frame_labels, dtype=np.int64))
            with open(self.output_dir / f"{name}.pkl", "wb") as f:
                pickle.dump(data, f)
            written.append(name)
        return written

    def generate_snitch_visible_frames(self) -> Path:
        """`visibility_rate_gt_<ratio>` annotation file: frames where the
        snitch is uncontained AND passes the occlusion test."""
        out = self.output_dir / f"visibility_rate_gt_{self.visible_ratio}.txt"
        lines = []
        thresh = 1 - self.visible_ratio
        for name in self._video_names():
            scene, gt_bb = self._load(name)
            visible = []
            for frame_bb, frame_labels, frame_coords, cam in \
                    self._scene_frames(scene, gt_bb):
                if SNITCH_INDEX not in frame_labels:
                    visible.append(False)
                    continue
                snitch_at = list(frame_labels).index(SNITCH_INDEX)
                snitch_bb = frame_bb[snitch_at]
                snitch_coord = frame_coords[snitch_at]
                flag = True
                for k in range(len(frame_bb)):
                    if k == snitch_at:
                        continue
                    result = occluded_pair(snitch_bb, frame_bb[k], snitch_coord,
                                           frame_coords[k], thresh,
                                           camera_location=cam)
                    if result is not None and result[0]:
                        flag = False
                        break
                visible.append(flag)
            frames = ",".join(str(i) for i in np.flatnonzero(visible))
            lines.append(f"{name}\t{frames}\n")
        out.write_text("".join(lines))
        return out
