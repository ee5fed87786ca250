"""Deterministic synthetic perfect-perception fixtures.

Mirrors the role of the reference's GT-derived "perfect perception"
generator (`generate/get_perfect_perception_and_visible_snitch_ratio.py`):
produce per-video perception pickles + GT label jsons + containment
annotation files in exactly the reference's on-disk schema, but from a
tiny scripted simulator instead of Blender renders — so the full
train/infer/analyze stack runs end-to-end in tests and benches with no
CATER data.

Each scene: the snitch plus a few cones/distractors move along smooth
paths; scripted containment events hide the snitch under a cone for a
frame range (the cone "carries" it), including occasional occlusion by a
non-cone (snitch invisible, no containment annotation).
"""

import json
import pickle
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from objectpermanence_tpu_torch import FRAME_HEIGHT, FRAME_WIDTH, VIDEO_NUM_FRAMES
from objectpermanence_tpu_torch.vocab import (
    IS_CONE, NUM_CLASSES, SNITCH_CLASS_INDEX, SNITCH_TRACK_NAME, OBJECTS_IDX_TO_NAME,
)

_CONE_IDS = np.flatnonzero(IS_CONE)
_NON_CONE_IDS = np.array(
    [i for i in range(NUM_CLASSES) if not IS_CONE[i] and i != SNITCH_CLASS_INDEX]
)


def _smooth_path(rng: np.random.RandomState, num_frames: int) -> np.ndarray:
    """A smooth (num_frames, 2) center trajectory inside the frame."""
    knots = rng.randint(4, 7)
    t_knots = np.linspace(0, num_frames - 1, knots)
    cx = rng.uniform(40, FRAME_WIDTH - 40, knots)
    cy = rng.uniform(40, FRAME_HEIGHT - 40, knots)
    t = np.arange(num_frames)
    return np.stack([np.interp(t, t_knots, cx), np.interp(t, t_knots, cy)], axis=-1)


def make_scene(seed: int, num_frames: int = VIDEO_NUM_FRAMES,
               num_objects: int = 6) -> Dict[str, np.ndarray]:
    """Simulate one scene. Returns dict with:
    - `boxes (T, K, 4)` xyxy pixel boxes per object (object 0 = snitch)
    - `classes (K,)` class ids
    - `visible (T, K)` bool
    - `contained (T,)` bool — snitch contained by a cone
    - `occluded (T,)` bool — snitch hidden without containment
    """
    rng = np.random.RandomState(seed)
    classes = [SNITCH_CLASS_INDEX]
    # at least two cones (potential containers), rest random distractors
    classes += list(rng.choice(_CONE_IDS, 2, replace=False))
    extra = max(0, num_objects - 3)
    classes += list(rng.choice(_NON_CONE_IDS, extra, replace=False))
    classes = np.array(classes[:num_objects])

    count = len(classes)
    sizes = rng.uniform(18, 42, (count, 2))
    sizes[0] = (16, 14)  # the snitch is small
    paths = np.stack([_smooth_path(rng, num_frames) for _ in range(count)])  # (K,T,2)

    visible = np.ones((num_frames, count), dtype=bool)
    contained = np.zeros(num_frames, dtype=bool)
    occluded = np.zeros(num_frames, dtype=bool)

    # scripted events on the timeline: [visible | contained-by-cone |
    # visible | occluded-by-distractor | visible | nested containment]
    def _span(lo_frac, hi_frac):
        return int(num_frames * lo_frac), int(num_frames * hi_frac)

    c1_start, c1_end = _span(0.2, 0.35)
    occ_start, occ_end = _span(0.5, 0.58)
    c2_start, c2_end = _span(0.7, 0.9)

    # containment event 1: cone 1 carries the snitch
    visible[c1_start:c1_end, 0] = False
    contained[c1_start:c1_end] = True
    paths[0, c1_start:c1_end] = paths[1, c1_start:c1_end]

    # occlusion event: distractor (or second cone) passes in front; the
    # snitch stays put but is not visible and not contained
    blocker = count - 1 if count > 3 else 2
    visible[occ_start:occ_end, 0] = False
    occluded[occ_start:occ_end] = True
    paths[blocker, occ_start:occ_end] = paths[0, occ_start:occ_end]

    # containment event 2: cone 2 carries the snitch; cone 2 itself gets
    # briefly covered by cone 1 ("babushka" nesting) in the middle
    visible[c2_start:c2_end, 0] = False
    contained[c2_start:c2_end] = True
    paths[0, c2_start:c2_end] = paths[2, c2_start:c2_end]
    nest_start = (c2_start + c2_end) // 2
    nest_end = min(nest_start + (c2_end - c2_start) // 4, c2_end - 2)
    visible[nest_start:nest_end, 2] = False
    paths[2, nest_start:nest_end] = paths[1, nest_start:nest_end]

    half = sizes[:, None, :].repeat(num_frames, 1) / 2  # (K,T,2)
    centers = paths  # (K,T,2)
    x1 = np.clip(centers[..., 0] - half[..., 0], 0, FRAME_WIDTH - 1)
    y1 = np.clip(centers[..., 1] - half[..., 1], 0, FRAME_HEIGHT - 1)
    x2 = np.clip(centers[..., 0] + half[..., 0], 1, FRAME_WIDTH)
    y2 = np.clip(centers[..., 1] + half[..., 1], 1, FRAME_HEIGHT)
    boxes = np.stack([x1, y1, x2, y2], axis=-1).transpose(1, 0, 2)  # (T,K,4)

    return {
        "boxes": boxes, "classes": classes, "visible": visible,
        "contained": contained, "occluded": occluded,
    }


def write_fixture_dataset(root, num_videos: int = 8, seed: int = 0,
                          num_frames: int = VIDEO_NUM_FRAMES,
                          num_objects: int = 6) -> Tuple[Path, Path, Path]:
    """Write a complete fixture dataset under `root`:
    - `od_perception/<name>.pkl` perception pickles ({"bb","labels"})
    - `labels/<name>_bb.json` GT track boxes (xywh) for every object
    - `containment_annotations.txt`, `containment_only_static.txt`,
      `containment_with_move.txt`, `visibility_rate_gt_0.txt` (et al.)
    Returns (predictions_dir, labels_dir, containment_file).
    """
    root = Path(root)
    pred_dir = root / "od_perception"
    labels_dir = root / "labels"
    pred_dir.mkdir(parents=True, exist_ok=True)
    labels_dir.mkdir(parents=True, exist_ok=True)

    containment_lines, static_lines, move_lines = [], [], []
    vis0_lines, vis30_lines, vis99_lines = [], [], []

    for v in range(num_videos):
        name = f"CATER_fixture_{v:06d}"
        scene = make_scene(seed * 1000 + v, num_frames, num_objects)
        boxes, classes, visible = scene["boxes"], scene["classes"], scene["visible"]

        # perception pickle: visible objects only, reference schema
        frame_bbs: List[np.ndarray] = []
        frame_labels: List[np.ndarray] = []
        for f in range(num_frames):
            mask = visible[f]
            frame_bbs.append(boxes[f, mask].astype(np.float32))
            frame_labels.append(classes[mask].astype(np.int64))
        with open(pred_dir / f"{name}.pkl", "wb") as fh:
            pickle.dump({"bb": frame_bbs, "labels": frame_labels}, fh)

        # GT labels json: xywh per track; track key is
        # `<class_name>_<Shape>_<instance>` — the snitch key matches the
        # reference's `small_gold_spl_metal_Spl_0`
        tracks = {}
        for k, cls in enumerate(classes):
            if k == 0:
                key = SNITCH_TRACK_NAME
            else:
                key = f"{OBJECTS_IDX_TO_NAME[cls]}_Obj_{k}"
            xywh = np.stack([
                boxes[:, k, 0], boxes[:, k, 1],
                boxes[:, k, 2] - boxes[:, k, 0], boxes[:, k, 3] - boxes[:, k, 1],
            ], axis=-1)
            tracks[key] = [[float(a) for a in row] for row in xywh]
        with open(labels_dir / f"{name}_bb.json", "w") as fh:
            json.dump(tracks, fh)

        def _frames_str(mask):
            return ",".join(str(i) for i in np.flatnonzero(mask))

        contained, occluded = scene["contained"], scene["occluded"]
        containment_lines.append(f"{name}\t{_frames_str(contained)}")
        # in the fixture all containment involves carried movement
        static_lines.append(f"{name}\t")
        move_lines.append(f"{name}\t{_frames_str(contained)}")
        vis_mask = visible[:, 0]
        vis0_lines.append(f"{name}\t{_frames_str(vis_mask)}")
        vis30_lines.append(f"{name}\t{_frames_str(vis_mask)}")
        vis99_lines.append(f"{name}\t{_frames_str(vis_mask)}")

    files = {
        "containment_annotations.txt": containment_lines,
        "containment_only_static.txt": static_lines,
        "containment_with_move.txt": move_lines,
        "visibility_rate_gt_0.txt": vis0_lines,
        "visibility_rate_gt_30.txt": vis30_lines,
        "visibility_rate_gt_99.txt": vis99_lines,
    }
    for fname, lines in files.items():
        (root / fname).write_text("".join(line + "\n" for line in lines))

    return pred_dir, labels_dir, root / "containment_annotations.txt"
