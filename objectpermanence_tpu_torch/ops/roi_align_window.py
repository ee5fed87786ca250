"""The windowed RoIAlign (K9's function) in plain PyTorch, and its contract
counters: the port's copy of the windowed part of
`objectpermanence_tpu/ops/pallas_roi_align.py` (`_window_quant`,
`windowed_out_of_contract_mask`, `_out_of_window_mask`, the window origins
of `roi_align_pallas_windowed`, `contract_stats`).

The windowed kernel reads each roi from a square window of its level and
drops every bilinear tap outside it. The window is the requested `win`
(48 px) widened to the TPU's alignment quanta, which depend on the
features' element size and the channel chunk (`window_quant`): at C=256 and
chunk 128 it is 56 px for float32 and 64 px for bfloat16. Its origin is one
pixel before the roi's corner, clamped so the window stays inside the level
zero-padded to a multiple of the quanta, then floored to the quantum. Under
the canonical FPN assignment a roi only leaves its window beyond about 5:1
aspect; such a roi is "out of contract" and gets the documented
approximation. Which taps drop, and so the function, depend on the dtype and
the chunk, never on the kernel's tiling (`r_blk`).

The counters make that visible: every dispatch of the windowed kernel
counts its rois and those out of contract, and the first read that finds a
violation warns once. The kernel adds its count to an int64 tensor on the
card (no host sync per dispatch); `contract_stats()` brings it to the host.
`OP_TPU_ROI_CONTRACT_STATS=0` switches the counting off, as in JAX.
"""

import math
import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from objectpermanence_tpu_torch.ops.roi_align import _align, _per_level, _sample_coords


def window_quant(itemsize: int, cc: int, win: int) -> Tuple[int, int, int]:
    """The windowed kernel's alignment quanta and widened window size for a
    feature dtype of `itemsize` bytes and channel chunk `cc`: (win, y_quant,
    x_quant). y: the sublane tile (8 rows of float32, 16 of bfloat16); x: so
    that x0 * cc is a multiple of 128 lanes. The window grows by one quantum
    (flooring the origin moves it back by less than that) and is rounded up
    to a multiple of both (powers of two, so of the larger)."""
    y_quant = 8 * (4 // itemsize)
    x_quant = 128 // math.gcd(cc, 128)
    quant = max(y_quant, x_quant)
    return -(-(win + quant) // quant) * quant, y_quant, x_quant


@dataclass(frozen=True)
class Window:
    """The window geometry of one windowed call: the widened `size`, the
    quanta, and each level's padded height and width."""
    size: int
    y_quant: int
    x_quant: int
    padded_h: Tuple[int, ...]
    padded_w: Tuple[int, ...]

    @classmethod
    def of(cls, shapes: Sequence[Tuple[int, int]], channels: int, itemsize: int,
           channel_chunk: int = 128, win: int = 48) -> "Window":
        """For levels `shapes [(H_l, W_l)]` of `channels` channels of
        `itemsize` bytes; the chunk is the whole width when it does not
        divide `channels`, as in JAX."""
        cc = channel_chunk if channels % channel_chunk == 0 else channels
        size, y_quant, x_quant = window_quant(itemsize, cc, win)
        return cls(size, y_quant, x_quant,
                   tuple(-(-max(h, size) // y_quant) * y_quant for h, _ in shapes),
                   tuple(-(-max(w, size) // x_quant) * x_quant for _, w in shapes))

    def origins(self, corner: torch.Tensor, padded: torch.Tensor, quant: int) -> torch.Tensor:
        """(N,) int64 window starts on one axis: one tap before the roi's
        scaled corner `corner (N,)`, clamped to [0, padded - size], floored
        to `quant`."""
        start = torch.floor(corner).to(torch.int64) - 1
        start = torch.minimum(start.clamp(min=0), (padded - self.size).clamp(min=0))
        return torch.div(start, quant, rounding_mode="floor") * quant

    def holds(self, taps: torch.Tensor, origins: torch.Tensor) -> torch.Tensor:
        """Whether taps `(N, K)` of one axis lie in the windows starting at
        `origins (N,)`."""
        rel = taps - origins[:, None]
        return (rel >= 0) & (rel < self.size)


def _out_of_window_mask(shapes: Sequence[Tuple[int, int]], rois: torch.Tensor,
                       levels: torch.Tensor, scales: torch.Tensor, pooled: int,
                       sampling_ratio: int, window: Window) -> torch.Tensor:
    """(N,) bool: True where the windowed kernel drops a nonzero-weight tap
    of a sample inside the level on that axis (JAX's `_out_of_window_mask`)."""
    x1, y1, xs, ys = _sample_coords(rois, levels, scales, pooled, sampling_ratio)

    def axis_bad(coords, sizes, padded, corner, quant):
        origin = window.origins(corner, padded, quant)
        size = sizes[:, None]
        fsize = size.to(torch.float32)
        inside = (coords >= -1.0) & (coords <= fsize)
        c = torch.minimum(coords.clamp(min=0.0), fsize - 1)
        c0 = torch.floor(c)
        frac = c - c0
        rel0 = c0.to(torch.int64) - origin[:, None]
        rel1 = torch.minimum(c0.to(torch.int64) + 1, size - 1) - origin[:, None]
        bad = (rel0 < 0) | (rel0 > window.size - 1) | ((frac > 0) & (rel1 > window.size - 1))
        return (inside & bad).any(dim=1)

    heights = _per_level([h for h, _ in shapes], levels)[:, 0]
    widths = _per_level([w for _, w in shapes], levels)[:, 0]
    return (axis_bad(ys, heights, _per_level(window.padded_h, levels)[:, 0], y1, window.y_quant)
            | axis_bad(xs, widths, _per_level(window.padded_w, levels)[:, 0], x1,
                       window.x_quant))


def _scales(strides: Sequence[float], device) -> torch.Tensor:
    return 1.0 / torch.tensor(list(strides), dtype=torch.float32, device=device)


def windowed_out_of_contract_mask(rois: torch.Tensor, levels: torch.Tensor,
                                  level_shapes: Sequence[Tuple[int, int, float]], *,
                                  channels: int, itemsize: int = 4, pooled: int = 7,
                                  sampling_ratio: int = 2, channel_chunk: int = 128,
                                  win: int = 48) -> torch.Tensor:
    """(B, N) bool: the rois the windowed kernel at these settings counts as
    out of contract, without running it. `level_shapes [(H_l, W_l,
    stride_l)]` of the unpadded pyramid."""
    shapes = [(int(h), int(w)) for h, w, _ in level_shapes]
    window = Window.of(shapes, channels, itemsize, channel_chunk, win)
    b, n = rois.shape[:2]
    mask = _out_of_window_mask(shapes, rois.reshape(b * n, 4), levels.reshape(b * n),
                              _scales([s for _, _, s in level_shapes], rois.device), pooled,
                              sampling_ratio, window)
    return mask.reshape(b, n)


def multilevel_roi_align_windowed(features: List[torch.Tensor], rois: torch.Tensor,
                                  levels: torch.Tensor, strides: Sequence[int],
                                  pooled: int = 7, sampling_ratio: int = 2,
                                  channel_chunk: int = 128, win: int = 48) -> torch.Tensor:
    """K9's function for one image: `multilevel_roi_align` with every tap
    outside its roi's window dropped. features [(C, H_l, W_l)] float32 or
    bfloat16 (the window follows their dtype; bfloat16 is read as float32),
    rois (N, 4), levels (N,) -> (N, C, pooled, pooled) float32."""
    shapes = [tuple(f.shape[1:]) for f in features]
    window = Window.of(shapes, features[0].shape[0], features[0].element_size(),
                       channel_chunk, win)
    return _align([f.float() for f in features], rois, levels, _scales(strides, rois.device),
                  pooled, sampling_ratio, window)


# --- contract counters ---------------------------------------------------------

_CONTRACT_STATS = {"rois": 0, "warned": False}
_OUT_OF_CONTRACT: Dict[torch.device, torch.Tensor] = {}


def contract_stats_active() -> bool:
    return os.environ.get("OP_TPU_ROI_CONTRACT_STATS", "1") != "0"


def out_of_contract_counter(device: torch.device) -> torch.Tensor:
    """The int64 count on `device` that windowed dispatches add to (a normal
    tensor even when first asked for under inference mode, so that a reset
    outside it may zero it)."""
    if device not in _OUT_OF_CONTRACT:
        with torch.inference_mode(False):
            _OUT_OF_CONTRACT[device] = torch.zeros((), dtype=torch.int64, device=device)
    return _OUT_OF_CONTRACT[device]


def count_dispatch(rois: int) -> None:
    """Count a dispatch's roi slots (its out-of-contract ones are added on
    the device)."""
    _CONTRACT_STATS["rois"] += rois


def contract_stats() -> dict:
    """{rois, out_of_contract} seen by windowed dispatches since the last
    reset. Counts every dispatched roi slot, including suppressed and padded
    proposals. Reads the devices' counts (a host sync), and warns the first
    time one is found out of contract."""
    out = sum(int(t.item()) for t in _OUT_OF_CONTRACT.values())
    if out and not _CONTRACT_STATS["warned"]:
        _CONTRACT_STATS["warned"] = True
        warnings.warn(
            f"windowed RoIAlign: {out}/{_CONTRACT_STATS['rois']} rois so far exceed the window "
            f"contract (>~5:1 aspect at their FPN level) and get the documented window "
            f"approximation; see ops.roi_align_window.contract_stats() for running totals",
            RuntimeWarning, stacklevel=2)
    return {"rois": _CONTRACT_STATS["rois"], "out_of_contract": out}


def reset_contract_stats() -> None:
    for t in _OUT_OF_CONTRACT.values():
        t.zero_()
    _CONTRACT_STATS.update(rois=0, warned=False)
