"""Prediction files, the counterpart of `write_bb_predictions` in
`objectpermanence_tpu/analysis/analyzer.py`. The IoU analyzer itself is
ported in a later slice."""

import json
from pathlib import Path

import numpy as np


def write_bb_predictions(video_name: str, predictions_dir, boxes) -> Path:
    """Write `<name>_bb.json`: a list of int `[x1, y1, x2, y2]`, one per
    frame. Written to a temporary file and renamed, so a crash never leaves
    a truncated file."""
    path = Path(predictions_dir) / f"{video_name}_bb.json"
    data = [[int(x1), int(y1), int(x2), int(y2)] for x1, y1, x2, y2 in np.asarray(boxes)]
    tmp = path.with_suffix(".json.tmp")
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2)
    tmp.replace(path)
    return path
