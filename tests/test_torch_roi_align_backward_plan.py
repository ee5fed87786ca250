"""K8's launch plan and the premise of its tiled decomposition, on the CPU
(`ops/roi_align_kernel.py::backward_launch_plan`, `roi_footprints`,
`roi_align_backward_bins_reference`; `csrc/roi_align.cu`).

K8 writes dF tile by tile: a block owns a tile of one level of one image and
a slice of channels, and adds, in roi order, the share of every roi that the
binning lists for its tile. That is right only if

- the plan fits a block's 227 KB of shared memory and its slices cover the
  channels, for every size the wrappers take;
- every tap of nonzero weight of every roi (`ops/roi_align.py::_geometry`,
  the plain version's) lies inside the footprint the binning computes, so a
  tile a roi reaches lists it;
- the tiles' sums, each roi's separable share `Ay^T (dOut Ax)` restricted to
  the tile and taken in list order, add up to the plain backward.

The kernel itself runs only on the card (`tests/test_torch_kernels_gpu.py`);
here a torch emulation of its decomposition, in this file, is held against
`multilevel_roi_align_backward` within 1e-6 x max(1, max |ref|): float32
sums in another order.
"""

import numpy as np
import pytest
import torch

from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES, assign_levels
from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
from objectpermanence_tpu_torch.ops.roi_align import _geometry, multilevel_roi_align_backward
from torch_lane import one_torch_thread  # noqa: F401

CHANNELS = [1, 64, 96, 200, 256, 512]
NATIVE = [(64, 80), (32, 40), (16, 20), (8, 10)]
P800 = [(200, 272), (100, 136), (50, 68), (25, 34)]
GEOMETRIES = {"native": (NATIVE, (320, 256)), "800": (P800, (1088, 800))}
EMULATION_RTOL = 1e-6


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("pooled", range(1, rk.MAX_POOLED + 1))
def test_backward_launch_plan_fits_and_covers_the_channels(pooled, itemsize):
    for sampling in range(1, rk.MAX_SAMPLES // pooled + 1):
        k = pooled * sampling
        for channels in CHANNELS:
            plan = rk.backward_launch_plan(channels, pooled, sampling, itemsize)
            assert plan["smem"] + rk.BACKWARD_STATIC_SMEM <= rk.SMEM_PER_BLOCK
            # a ring of dOut slices and sample tables, two buffers of weights; the
            # staged tile
            dout = rk.BACKWARD_STAGES * plan["slice"] * ((pooled * pooled) | 1) * 4
            weights = 2 * pooled * (plan["tile_w"] + plan["tile_h"]) * 4
            assert plan["smem"] >= dout + rk.BACKWARD_STAGES * (2 * k + 1) * 16 + weights
            assert plan["smem"] >= plan["slice"] * (plan["tile_h"] * plan["tile_w"] + 1) * 4
            assert plan["slice"] % 32 == 0 and plan["tile_w"] * itemsize == 32  # a sector a row
            assert plan["tile_h"] == rk.BACKWARD_TILE_H
            assert plan["threads"] == plan["slice"] * plan["tile_w"] <= rk.BACKWARD_THREADS
            assert (plan["blocks"] - 1) * plan["slice"] < channels <= plan["blocks"] * plan["slice"]


@pytest.mark.parametrize("channels,pooled,sampling,itemsize", [
    (256, rk.MAX_POOLED + 1, 1, 4), (256, 8, 5, 4), (256, 1, rk.MAX_SAMPLES + 1, 2),
    (256, 7, 0, 4), (256, 0, 2, 4), (0, 7, 2, 4), (256, 7, 2, 8)])
def test_backward_launch_plan_raises_beyond_the_wrappers_limits(channels, pooled, sampling,
                                                                itemsize):
    with pytest.raises(ValueError):
        rk.backward_launch_plan(channels, pooled, sampling, itemsize)


def test_backward_refuses_more_tiles_than_a_grid_axis():
    grad = torch.zeros((1, 1, 1, 7, 7))
    rois = torch.zeros((1, 1, 4))
    levels = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="tiles"):
        rk.roi_align_batched_backward(grad, rois, levels, [(4096, 4112)], [4])


def _rois(rng, n, width, height):
    """Rois of every size (0.3 px to twice the image) and aspect (up to 1:80),
    some across or beyond the image's edges."""
    xy = rng.uniform(-0.2, 1.1, (n, 2)) * [width, height]
    side = np.exp(rng.uniform(np.log(0.3), np.log(2 * max(width, height)), n))
    aspect = np.exp(rng.uniform(-np.log(80), np.log(80), n))
    wh = np.stack([side * np.sqrt(aspect), side / np.sqrt(aspect)], -1)
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))


def _edge_rois(width, height):
    """Sub-pixel, across each edge, beyond the image, zero-sized, on the last
    pixel, and the whole image."""
    return torch.tensor([[10.2, 20.7, 10.3, 20.8], [-30.0, 0.4 * height, 25.0, 0.6 * height],
                         [0.5 * width, -50.0, 0.7 * width, 10.0],
                         [-300.0, -300.0, -200.0, -200.0], [0.0, 0.0, 0.0, 0.0],
                         [width - 0.5, height - 0.5, width, height],
                         [-5.0, -5.0, width + 5.0, height + 5.0]])


@pytest.mark.parametrize("pooled,sampling", [(7, 2), (9, 3), (2, 16), (4, 1)])
@pytest.mark.parametrize("geometry", ["native", "800"])
def test_roi_footprints_hold_every_tap(geometry, pooled, sampling):
    shapes, image = GEOMETRIES[geometry]
    rois = torch.cat([_rois(np.random.RandomState(pooled * 10 + sampling), 400, *image),
                      _edge_rois(*image)])
    levels = assign_levels(rois)
    scales = 1.0 / torch.tensor(ROI_STRIDES, dtype=torch.float32)
    rows, weights, inside = _geometry(shapes, rois, levels, scales, pooled, sampling)
    lo, hi = rk.roi_footprints(rois, levels, shapes, ROI_STRIDES, pooled, sampling)
    offsets = np.cumsum([0] + [h * w for h, w in shapes])
    widths = np.array([w for _, w in shapes])
    empty = 0
    for n in range(rois.shape[0]):
        level = int(levels[n])
        taps = torch.cat([row[n][(weight[n] != 0) & inside[n]]
                          for row, weight in zip(rows, weights)]).numpy() - offsets[level]
        if (lo[n] > hi[n]).any():
            assert taps.size == 0, (n, rois[n])
            empty += 1
            continue
        ys, xs = taps // widths[level], taps % widths[level]
        assert taps.size == 0 or (lo[n, 0] <= ys.min() and ys.max() <= hi[n, 0]
                                  and lo[n, 1] <= xs.min() and xs.max() <= hi[n, 1]), n
        assert 0 <= lo[n, 0] and hi[n, 0] < shapes[level][0]
        assert 0 <= lo[n, 1] and hi[n, 1] < shapes[level][1]
    assert empty >= 1  # the roi beyond the image adds nothing and is binned nowhere


def _emulate(grad, rois, levels, shapes, pooled, sampling, dtype):
    """K8's decomposition in torch, at the tiles of dF in `dtype`: per image
    and tile, the listed rois in order, each adding Ay^T (dOut Ax) over the
    tile from its sample table; then 1/s^2 and the tile written once (the
    float32 sums: the bf16 mode rounds them as it writes them)."""
    bins = rk.roi_align_backward_bins_reference(rois, levels, shapes, ROI_STRIDES, pooled,
                                                sampling, dtype)
    th, tw = rk.BACKWARD_TILE_H, rk.backward_tile_w(dtype.itemsize)
    level_of, tile_y, tile_x = rk.backward_tiles(shapes, tw)
    batch, channels = grad.shape[0], grad.shape[2]
    out = [torch.full((batch, channels, h, w), float("nan")) for h, w in shapes]
    table = bins["table"]
    for b in range(batch):
        for t in range(level_of.numel()):
            level, y0, x0 = int(level_of[t]), int(tile_y[t]) * th, int(tile_x[t]) * tw
            acc = torch.zeros((channels, th, tw))
            for n in bins["lists"][b, t, :int(bins["counts"][b, t])].tolist():
                entry = table[b, n, :-1].reshape(2, -1, 4)  # the samples; the footprint last
                taps, w = entry[..., :2].long(), entry[..., 2:].contiguous().view(torch.float32)
                at = [torch.arange(y0, y0 + th), torch.arange(x0, x0 + tw)]
                # (axis, pooled, tile extent): each bin's samples' weights on each tap
                hit = [(taps[a, :, :, None] == at[a]) * w[a, :, :, None] for a in range(2)]
                ay, ax = [(h[:, 0] + h[:, 1]).reshape(pooled, sampling, -1).sum(1) for h in hit]
                acc += torch.einsum("py,cpx->cyx", ay, grad[b, n] @ ax)
            h, w = shapes[level]
            tile = acc * (1.0 / (sampling * sampling))
            out[level][b, :, y0:y0 + th, x0:x0 + tw] = tile[:, :h - y0, :w - x0]
    return out, bins


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pooled,sampling", [(7, 2), (3, 1), (2, 4)])
@pytest.mark.parametrize("geometry", ["native", "800"])
def test_tiled_decomposition_sums_to_the_backward(geometry, pooled, sampling, dtype):
    shapes, image = GEOMETRIES[geometry]
    rng = np.random.RandomState(pooled * 7 + sampling)
    batch, n, channels = 2, 30, 3
    rois = torch.stack([torch.cat([_rois(rng, n - 10, *image), _edge_rois(*image),
                                   torch.tensor([[40.0, 30.0, 95.0, 70.0]] * 3)])
                        for _ in range(batch)])
    levels = torch.stack([assign_levels(r) for r in rois])
    levels[1, :4] = 3  # other levels than the sizes give, the clamp to P5 too
    grad = torch.from_numpy(rng.standard_normal((batch, n, channels, pooled, pooled))
                            .astype(np.float32))
    got, bins = _emulate(grad, rois, levels, shapes, pooled, sampling, dtype)
    want = [torch.stack(level) for level in zip(*[
        multilevel_roi_align_backward(grad[b], shapes, rois[b], levels[b], ROI_STRIDES,
                                      sampling) for b in range(batch)])]
    for g, w in zip(got, want):
        assert not torch.isnan(g).any()  # the tiles cover each level once
        assert (g - w).abs().max().item() <= EMULATION_RTOL * max(1.0, w.abs().max().item())
    assert int(bins["counts"].max()) >= 3  # the identical rois share their tiles
    for b in range(batch):
        for t in range(bins["counts"].shape[1]):
            listed = bins["lists"][b, t, :int(bins["counts"][b, t])]
            assert (listed[1:] > listed[:-1]).all() and (bins["lists"][b, t, listed.numel():]
                                                         == -1).all()
