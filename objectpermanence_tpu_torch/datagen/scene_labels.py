"""Scene json -> per-frame annotation files, the port's copy of
`objectpermanence_tpu/datagen/scene_labels.py`. Host numpy.

Port of `generate/gen_video_labels.py`: snitch containment frames,
containment-with-movement frames, the static = all - moving separation,
and the per-frame `tracked_object` carrier label including nested
("babushka") containment.
"""

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from objectpermanence_tpu_torch.vocab import OBJECTS_NAME_TO_IDX

SNITCH_INSTANCE = "Spl_0"
SNITCH_LABEL = 140
LAST_FRAME = 299  # zero-based index of the final frame (300-frame default)


def scene_last_frame(scene: dict) -> int:
    """Zero-based final frame of a scene json. The reference hardcodes 300
    frames; simulated test scenes can be shorter, so derive from the
    per-object locations when present."""
    objects = scene.get("objects") or []
    if objects and "locations" in objects[0]:
        return len(objects[0]["locations"]) - 1
    return LAST_FRAME


def object_class_name(instance: str, scene: dict) -> str:
    for obj in scene["objects"]:
        if obj["instance"] == instance:
            return "_".join(obj[a] for a in ["size", "color", "shape", "material"])
    raise KeyError(f"instance {instance!r} not in scene")


def class_label(class_name: str, class_names: Dict[str, int] = None) -> int:
    table = class_names or OBJECTS_NAME_TO_IDX
    return table[class_name]


def _action_flags(action_list: Sequence, kind: str) -> List[bool]:
    return [kind in action[0] for action in action_list]


def containment_events(scene: dict, contained_instance: str = SNITCH_INSTANCE
                       ) -> List[Tuple[str, int, int]]:
    """All (cone_instance, start_frame, end_frame) containments of
    `contained_instance`: containment starts at the `_contain` action's end
    frame and runs until the cone's next `_pick_place` start (or the last
    frame) — reference `gen_video_labels.py:154-199`."""
    events = []
    for obj_name, actions in scene["movements"].items():
        if "Cone" not in obj_name:
            continue
        contain = _action_flags(actions, "_contain")
        pick_place = _action_flags(actions, "_pick_place")
        for idx, is_contain in enumerate(contain):
            if not is_contain or actions[idx][1] != contained_instance:
                continue
            start = actions[idx][3]
            later_pick = [j for j in range(idx, len(actions)) if pick_place[j]]
            end = (actions[later_pick[0]][2] if later_pick
                   else scene_last_frame(scene))
            events.append((obj_name, start, end))
    return events


def snitch_containment_frames(scene: dict) -> List[int]:
    frames: List[int] = []
    for _, start, end in containment_events(scene):
        frames.extend(range(start, end + 1))
    return sorted(frames)


def snitch_containment_with_move_frames(scene: dict) -> List[int]:
    """Frames where a cone slides WHILE containing the snitch
    (reference `gen_video_labels.py:96-141`)."""
    frames: List[int] = []
    for obj_name, actions in scene["movements"].items():
        if "Cone" not in obj_name:
            continue
        contain = _action_flags(actions, "_contain")
        pick_place = _action_flags(actions, "_pick_place")
        slide = _action_flags(actions, "_slide")
        for idx, is_contain in enumerate(contain):
            if not is_contain or actions[idx][1] != SNITCH_INSTANCE:
                continue
            later_slides = [j for j in range(idx, len(actions)) if slide[j]]
            if not later_slides:
                continue
            later_picks = [j for j in range(idx, len(actions)) if pick_place[j]]
            end = (actions[later_picks[0]][2] if later_picks
                   else scene_last_frame(scene))
            for j in later_slides:
                slide_start, slide_end = actions[j][2], actions[j][3]
                if slide_end <= end:
                    frames.extend(range(slide_start, slide_end + 1))
    return sorted(frames)


def static_frames(all_frames: Sequence[int], moving_frames: Sequence[int]) -> List[int]:
    """static = all - moving (reference `gen_video_labels.py:33-54`)."""
    moving = set(moving_frames)
    return [f for f in all_frames if f not in moving]


def tracked_object_labels(scene: dict, class_names: Dict[str, int] = None
                          ) -> Tuple[np.ndarray, int]:
    """Per-frame class label of the object carrying the snitch signal,
    one level of nested ("babushka") containment deep
    (reference `gen_video_labels.py:202-215`). Returns (labels (300,),
    babushka_frame_count)."""
    labels = np.full(scene_last_frame(scene) + 1, SNITCH_LABEL, dtype=int)
    babushka_count = 0

    snitch_events = containment_events(scene)
    for cone, start, end in snitch_events:
        cone_label = class_label(object_class_name(cone, scene), class_names)
        labels[start:end + 1] = cone_label

    for cone in {name for name, _, _ in snitch_events}:
        outer_events = containment_events(scene, contained_instance=cone)
        count = 0
        for outer_cone, start, end in outer_events:
            outer_label = class_label(object_class_name(outer_cone, scene), class_names)
            labels[start:end + 1] = outer_label
            count += end - start + 1
        if count:
            babushka_count = count
    return labels, babushka_count


def _frames_line(name: str, frames: Sequence[int]) -> str:
    return f"{name}\t{','.join(str(f) for f in frames)}\n"


def write_annotation_files(scenes_dir, output_dir, *, class_names=None) -> Dict[str, Path]:
    """Derive every annotation file for a directory of scene jsons:
    containment, containment-with-move, static containment, and the
    tracked_object labels + babushka counts CSV."""
    scenes_dir, output_dir = Path(scenes_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    containment_lines, move_lines, static_lines, tracked_lines = [], [], [], []
    babushka_rows = ["video_name,num_babushka_frames\n"]

    for scene_path in sorted(scenes_dir.glob("*.json")):
        with open(scene_path) as f:
            scene = json.load(f)
        name = scene_path.stem
        contained = snitch_containment_frames(scene)
        moving = snitch_containment_with_move_frames(scene)
        containment_lines.append(_frames_line(name, contained))
        move_lines.append(_frames_line(name, moving))
        static_lines.append(_frames_line(name, static_frames(contained, moving)))
        tracked, babushka = tracked_object_labels(scene, class_names)
        tracked_lines.append(_frames_line(name, tracked.tolist()))
        babushka_rows.append(f"{name},{babushka}\n")

    paths = {
        "containment": output_dir / "containment_annotations.txt",
        "containment_with_move": output_dir / "containment_with_move_annotations.txt",
        "containment_only_static": output_dir / "containment_only_static_annotations.txt",
        "tracked_object": output_dir / "tracked_object.txt",
        "babushka": output_dir / "babushka.csv",
    }
    paths["containment"].write_text("".join(containment_lines))
    paths["containment_with_move"].write_text("".join(move_lines))
    paths["containment_only_static"].write_text("".join(static_lines))
    paths["tracked_object"].write_text("".join(tracked_lines))
    paths["babushka"].write_text("".join(babushka_rows))
    return paths
