"""The RoIAlign forward kernel's launch plan and the premise of its compact
tile, on the CPU (`ops/roi_align_kernel.py::launch_plan`,
`csrc/roi_align.cu`).

The plan must fit a block's 227 KB of shared memory with room for a pair
of channels of the largest tile, 2k x 2k pixels for k = pooled * sampling_ratio,
for every size the wrappers take, and its slices must cover the channels.
The kernel stages each roi's taps as a tile of its distinct rows x distinct
columns: checked here on the plain geometry (`ops/roi_align.py::_geometry`,
with and without K9's window) on seeded rois of every size and aspect, each
roi's taps of nonzero weight fall in at most 2k distinct rows and 2k
distinct columns of its level.
"""

import numpy as np
import pytest
import torch

from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES, assign_levels
from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
from objectpermanence_tpu_torch.ops.roi_align import _geometry
from objectpermanence_tpu_torch.ops.roi_align_window import Window

CHANNELS = [1, 64, 96, 200, 256, 512]
NATIVE = [(64, 80), (32, 40), (16, 20), (8, 10)]
P800 = [(200, 272), (100, 136), (50, 68), (25, 34)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("pooled", range(1, rk.MAX_POOLED + 1))
def test_launch_plan_fits_and_covers_the_channels(pooled, itemsize):
    for sampling in range(1, rk.MAX_SAMPLES // pooled + 1):
        k = pooled * sampling
        for channels in CHANNELS:
            plan = rk.launch_plan(channels, pooled, sampling, itemsize)
            assert plan["smem"] + rk.STATIC_SMEM <= rk.SMEM_PER_BLOCK
            assert plan["smem"] >= 40 * k * k + plan["tile_bytes"]
            # a pair of channels of the largest tile, 2k x 2k pixels, and their output
            pitch = rk._tile_pitch(4 * k * k)
            assert pitch >= 4 * k * k and pitch % 2 == 1
            assert plan["tile_bytes"] >= rk._pass_bytes(2, pitch, itemsize, pooled * pooled)
            assert 64 <= plan["threads"] <= 256 and plan["threads"] & (plan["threads"] - 1) == 0
            assert 1 <= plan["slice"] <= channels
            assert (plan["blocks"] - 1) * plan["slice"] < channels <= plan["blocks"] * plan["slice"]


@pytest.mark.parametrize("channels,pooled,sampling,itemsize", [
    (256, rk.MAX_POOLED + 1, 1, 4), (256, 8, 5, 4), (256, 1, rk.MAX_SAMPLES + 1, 2),
    (256, 7, 0, 4), (256, 0, 2, 4), (0, 7, 2, 4), (256, 7, 2, 8)])
def test_launch_plan_raises_beyond_the_wrappers_limits(channels, pooled, sampling, itemsize):
    with pytest.raises(ValueError):
        rk.launch_plan(channels, pooled, sampling, itemsize)


def _rois(rng, n, width, height):
    """Rois of every size (0.3 px to twice the image) and aspect (up to 1:80),
    some across or beyond the image's edges."""
    xy = rng.uniform(-0.2, 1.1, (n, 2)) * [width, height]
    side = np.exp(rng.uniform(np.log(0.3), np.log(2 * max(width, height)), n))
    aspect = np.exp(rng.uniform(-np.log(80), np.log(80), n))
    wh = np.stack([side * np.sqrt(aspect), side / np.sqrt(aspect)], -1)
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))


@pytest.mark.parametrize("pooled,sampling", [(7, 2), (9, 3), (2, 16), (4, 1)])
@pytest.mark.parametrize("geometry,window", [("native", None), ("800", None),
                                             ("800", "float32"), ("800", "bfloat16")])
def test_roi_taps_fit_the_compact_tile(geometry, window, pooled, sampling):
    shapes, image = (NATIVE, (320, 256)) if geometry == "native" else (P800, (1088, 800))
    rois = _rois(np.random.RandomState(pooled * 10 + sampling), 400, *image)
    levels = assign_levels(rois)
    win = None if window is None else Window.of(shapes, 256, 4 if window == "float32" else 2)
    scales = 1.0 / torch.tensor(ROI_STRIDES, dtype=torch.float32)
    rows, weights, inside = _geometry(shapes, rois, levels, scales, pooled, sampling, win)
    offsets = np.cumsum([0] + [h * w for h, w in shapes])
    widths = np.array([w for _, w in shapes])
    k = pooled * sampling
    most = 0
    for n in range(rois.shape[0]):
        level = int(levels[n])
        taps = torch.cat([row[n][(weight[n] != 0) & inside[n]]
                          for row, weight in zip(rows, weights)]).numpy() - offsets[level]
        assert taps.size == 0 or (taps.min() >= 0 and taps.max() < offsets[level + 1]
                                  - offsets[level])
        ys, xs = np.unique(taps // widths[level]), np.unique(taps % widths[level])
        assert ys.size <= 2 * k and xs.size <= 2 * k, (n, rois[n], ys.size, xs.size)
        most = max(most, ys.size, xs.size)
    assert most > k  # the test reaches tiles wider than one tap per sample
