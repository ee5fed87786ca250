"""Anchor generation for the FPN levels, the port's numpy copy of
`objectpermanence_tpu/models/detector/anchors.py` (torchvision
AnchorGenerator semantics: one size per level x 3 aspect ratios,
cell-cornered at stride * index, rounded base anchors)."""

from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_SIZES = (32, 64, 128, 256, 512)
DEFAULT_RATIOS = (0.5, 1.0, 2.0)


def base_anchors(size: float, ratios: Sequence[float] = DEFAULT_RATIOS) -> np.ndarray:
    """(num_ratios, 4) xyxy anchors centered at the origin."""
    ratios = np.asarray(ratios, dtype=np.float64)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios * size) / 2
    hs = (h_ratios * size) / 2
    return np.round(np.stack([-ws, -hs, ws, hs], axis=1)).astype(np.float32)


def level_anchors(feature_hw: Tuple[int, int], stride: int, size: float,
                  ratios: Sequence[float] = DEFAULT_RATIOS) -> np.ndarray:
    """All anchors for one level: (H*W*A, 4), ordered cell-major then
    ratio (matching the head's reshape order)."""
    h, w = feature_hw
    base = base_anchors(size, ratios)                      # (A, 4)
    shift_x = np.arange(w, dtype=np.float32) * stride
    shift_y = np.arange(h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)                 # (H, W)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def pyramid_anchors(feature_shapes: List[Tuple[int, int]], strides: Sequence[int],
                    sizes: Sequence[float] = DEFAULT_SIZES,
                    ratios: Sequence[float] = DEFAULT_RATIOS) -> List[np.ndarray]:
    return [level_anchors(hw, s, size, ratios)
            for hw, s, size in zip(feature_shapes, strides, sizes)]
