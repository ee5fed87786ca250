"""CATER class vocabulary: 193 `size_color_shape_material` classes.

The port's own copy of `objectpermanence_tpu/vocab.py`. Indices are assigned in blocks of (size, material), each
block sorted by (color, shape); the gold "spl" snitch shape exists only for
(small, metal) and lands at index 140.
"""

from functools import lru_cache

import numpy as np

SIZES = ("large", "medium", "small")
MATERIALS = ("metal", "rubber")
COLORS = ("blue", "brown", "cyan", "gray", "green", "purple", "red", "yellow")
SHAPES = ("cone", "cube", "cylinder", "sphere")

# The snitch ("spl" = special) exists only as a small gold metal object.
_SNITCH_COLOR_SHAPE = ("gold", "spl")


def _build_vocab():
    names = []
    for size in SIZES:
        for material in MATERIALS:
            combos = [(c, s) for c in COLORS for s in SHAPES]
            if size == "small" and material == "metal":
                combos.append(_SNITCH_COLOR_SHAPE)
            combos.sort()
            names.extend(f"{size}_{color}_{shape}_{material}" for color, shape in combos)
    return {name: idx for idx, name in enumerate(names)}


OBJECTS_NAME_TO_IDX = _build_vocab()
OBJECTS_IDX_TO_NAME = {idx: name for name, idx in OBJECTS_NAME_TO_IDX.items()}

NUM_CLASSES = len(OBJECTS_NAME_TO_IDX)
assert NUM_CLASSES == 193

SNITCH_CLASS_NAME = "small_gold_spl_metal"
SNITCH_CLASS_INDEX = OBJECTS_NAME_TO_IDX[SNITCH_CLASS_NAME]
assert SNITCH_CLASS_INDEX == 140

# Per-track key used in the CATER ground-truth bounding-box json files.
SNITCH_TRACK_NAME = "small_gold_spl_metal_Spl_0"

# Per-class cone flag (the 6-feature layout's last feature).
IS_CONE = np.array(
    ["_cone_" in OBJECTS_IDX_TO_NAME[i] for i in range(NUM_CLASSES)], dtype=bool
)


def is_cone_object(idx: int) -> int:
    return int(IS_CONE[idx])


@lru_cache(maxsize=None)
def large_cone_indices() -> tuple:
    """Class ids of the large cones: the trackers' box for a hidden snitch
    sits 15 px lower under one (reference `baselines/inference_main.py:18`)."""
    return tuple(i for i in range(NUM_CLASSES)
                 if OBJECTS_IDX_TO_NAME[i].startswith("large_") and IS_CONE[i])
