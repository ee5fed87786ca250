"""CATER task label generation, the port's copy of
`objectpermanence_tpu/datagen/cater_tasks.py`: snitch-localization grid
classes, action-present multilabels, action-order composite classes,
train/test splits. Host numpy.

Port of `generate/gen_train_test.py` (the CATER benchmark's label
tooling): classes are derived from scene jsons.
"""

import json
import math
from itertools import permutations, product
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

NUM_ROWS = NUM_COLS = 3  # the grid is labeled w.r.t. a 6x6 = (2*3)^2 grid

ACTION_CLASSES: List[Tuple[str, str]] = [
    ("sphere", "_slide"),
    ("sphere", "_pick_place"),
    ("spl", "_slide"),
    ("spl", "_pick_place"),
    ("spl", "_rotate"),
    ("cylinder", "_pick_place"),
    ("cylinder", "_slide"),
    ("cylinder", "_rotate"),
    ("cube", "_slide"),
    ("cube", "_pick_place"),
    ("cube", "_rotate"),
    ("cone", "_contain"),
    ("cone", "_pick_place"),
    ("cone", "_slide"),
]

BEFORE, DURING, AFTER = "before", "during", "after"
ORDERING = [BEFORE, DURING, AFTER]


def localization_class(scene: dict, num_rows: int = NUM_ROWS,
                       num_cols: int = NUM_COLS) -> int:
    """Final-frame snitch grid cell (reference `localize_dataset`,
    `gen_train_test.py:54-75`): floor the last 3D position into the
    (2*rows x 2*cols) grid."""
    snitch = next(el for el in scene["objects"] if el["shape"] == "spl")
    locations = snitch["locations"]
    pos = list(locations[str(len(locations) - 1)])
    if num_rows != NUM_ROWS or num_cols != NUM_COLS:
        pos[0] *= num_cols / NUM_COLS
        pos[1] *= num_rows / NUM_ROWS
    x = int(math.floor(pos[0])) + num_cols
    y = int(math.floor(pos[1])) + num_rows
    return y * (2 * num_cols) + x


def actions_present_labels(scene: dict) -> List[int]:
    """Multi-label action-present classes (reference
    `actions_or_not_dataset`)."""
    name_to_shape = {el["instance"]: el["shape"] for el in scene["objects"]}
    shape_actions: Dict[str, List[str]] = {}
    for name, motions in scene["movements"].items():
        shape_actions.setdefault(name_to_shape[name], []).extend(
            m[0] for m in motions)
    labels = []
    for action_id, (shape, movement) in enumerate(ACTION_CLASSES):
        if movement in shape_actions.get(shape, []):
            labels.append(action_id)
    return labels


def _ordering(a_time, b_time) -> str:
    if a_time[1] <= b_time[0]:
        return BEFORE
    if b_time[1] <= a_time[0]:
        return AFTER
    return DURING


def action_order_classes(n: int = 2, unique: bool = False) -> List:
    action_sets = list(product(ACTION_CLASSES, repeat=n))
    orderings = list(product(ORDERING, repeat=n - 1))
    classes = list(product(action_sets, orderings))
    if unique:
        # a class and its full reversal (actions reversed, orderings
        # reversed with before<->after flipped) describe the same event
        # set; keep the first of each pair (matches the reference's n=2
        # pair dedup, and generalizes it to any n)
        flip = {BEFORE: AFTER, AFTER: BEFORE, DURING: DURING}
        def reverse(el):
            return (tuple(reversed(el[0])),
                    tuple(flip[o] for o in reversed(el[1])))
        seen = set()
        uniq = []
        for el in classes:
            if el not in seen and reverse(el) not in seen:
                seen.add(el)
                uniq.append(el)
        classes = uniq
    return classes


def action_order_labels(scene: dict, classes: List, n: int = 2) -> List[int]:
    """Composite "X before/during/after Y" classes (reference
    `actions_order_dataset` + `compute_active_labels`)."""
    name_to_shape = {el["instance"]: el["shape"] for el in scene["objects"]}
    all_actions = [(name_to_shape[name], m)
                   for name, motions in scene["movements"].items()
                   for m in motions]
    active = set()
    for actions_set in permutations(all_actions, n):
        for cls_id, (ents, order) in enumerate(classes):
            ok = all(e[0] == a[0] and e[1] == a[1][0]
                     for e, a in zip(ents, actions_set))
            if not ok:
                continue
            if all(_ordering(actions_set[i][1][2:], actions_set[i + 1][1][2:])
                   == order[i] for i in range(len(order))):
                active.add(cls_id)
    return sorted(active)


def train_test_split(names: Sequence[str], train_fraction: float = 0.7,
                     seed: int = 0) -> Tuple[List[str], List[str]]:
    names = list(names)
    np.random.RandomState(seed).shuffle(names)
    cut = int(train_fraction * len(names))
    return names[:cut], names[cut:]


def write_task_labels(scenes_dir, output_dir, *, seed: int = 0,
                      action_order_n: int = 2) -> Dict[str, Path]:
    """Write every CATER benchmark dataset the reference's label tooling
    emits (`gen_train_test.py:298-330` `dataset_gen_fns`): per-dataset
    directories `localize/`, `localize_4x4/`, `localize_8x8/`,
    `actions_present/`, `actions_order_uniq/`, each holding
    `train.txt`/`val.txt` of "<video> <label[,label...]>" lines with
    empty-label rows dropped (reference `len(str(label)) > 0` filter,
    `gen_train_test.py:320-323`), plus the legacy flat files
    (`localize.txt`, `actions_present.txt`, `train.txt`, `val.txt`).

    Returns {key: path}; per-dataset split files are keyed
    "<dataset>/<split>" (e.g. "actions_order_uniq/train")."""
    scenes_dir, output_dir = Path(scenes_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    order_classes = action_order_classes(n=action_order_n, unique=True)
    # label text per dataset per video; localize labels are ints (never
    # empty), multilabel datasets comma-join and may be empty
    datasets: Dict[str, List[Tuple[str, str]]] = {
        "localize": [], "localize_4x4": [], "localize_8x8": [],
        "actions_present": [], "actions_order_uniq": [],
    }
    names = []
    for scene_path in sorted(scenes_dir.glob("*.json")):
        with open(scene_path) as f:
            scene = json.load(f)
        name = f"{scene_path.stem}.avi"
        names.append(name)
        datasets["localize"].append((name, str(localization_class(scene))))
        # reference localize_4x4 passes num_rows=num_cols=2, 8x8 passes 4
        datasets["localize_4x4"].append(
            (name, str(localization_class(scene, 2, 2))))
        datasets["localize_8x8"].append(
            (name, str(localization_class(scene, 4, 4))))
        datasets["actions_present"].append(
            (name, ",".join(str(l) for l in actions_present_labels(scene))))
        datasets["actions_order_uniq"].append(
            (name, ",".join(str(l) for l in action_order_labels(
                scene, order_classes, n=action_order_n))))

    train, val = train_test_split(names, seed=seed)

    paths = {
        "localize": output_dir / "localize.txt",
        "actions_present": output_dir / "actions_present.txt",
        "train": output_dir / "train.txt",
        "val": output_dir / "val.txt",
    }
    paths["localize"].write_text(
        "".join(f"{n} {l}\n" for n, l in datasets["localize"]))
    paths["actions_present"].write_text(
        "".join(f"{n} {l}\n" for n, l in datasets["actions_present"]))
    paths["train"].write_text("".join(f"{n}\n" for n in train))
    paths["val"].write_text("".join(f"{n}\n" for n in val))

    for dset_name, rows in datasets.items():
        dset_dir = output_dir / dset_name
        dset_dir.mkdir(exist_ok=True)
        by_name = dict(rows)
        for split, members in (("train", train), ("val", val)):
            lines = [f"{n} {by_name[n]}\n" for n in members
                     if len(by_name[n]) > 0]
            p = dset_dir / f"{split}.txt"
            p.write_text("".join(lines))
            paths[f"{dset_name}/{split}"] = p
        # the reference persists the full class table (metadata.pkl with the
        # classes list); serialize it too so label ids are recoverable from
        # the emitted artifacts alone (ADVICE r4: actions_order_uniq ids
        # otherwise depend on re-running action_order_classes with the same n)
        if dset_name == "actions_order_uniq":
            meta = {"num_classes": len(order_classes),
                    "action_order_n": action_order_n,
                    "classes": order_classes}
        elif dset_name == "actions_present":
            meta = {"num_classes": len(ACTION_CLASSES),
                    "classes": list(ACTION_CLASSES)}
        else:
            meta = {"num_classes": {"localize": 36, "localize_4x4": 16,
                                    "localize_8x8": 64}[dset_name]}
        (dset_dir / "metadata.json").write_text(json.dumps(meta))
    return paths
