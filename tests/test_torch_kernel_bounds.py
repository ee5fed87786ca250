"""The bytes a RoIAlign forward must read, as chip_smoke.py counts them for
its bounds (`roi_pixels_read`): the (image, level, pixel) taps that the rois
reach with a nonzero weight, inside their window for the windowed RoIAlign.
Held to the pixels where the plain function's gradient, under a positive
cotangent, is nonzero: those and only those change its output."""

import pytest
import torch

import chip_smoke
from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES, assign_levels
from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
from objectpermanence_tpu_torch.ops.roi_align import _align

SHAPES = [(200, 272), (100, 136), (50, 68), (25, 34)]   # the 800 px pyramid


def _inputs(dtype, batch=2, n=40, channels=4):
    gen = torch.Generator().manual_seed(0)
    feats = [torch.randn(batch, channels, h, w, generator=gen).to(dtype) for h, w in SHAPES]
    corner = torch.rand(batch, n, 2, generator=gen) * torch.tensor([1000.0, 760.0])
    rois = torch.cat([corner, corner + torch.rand(batch, n, 2, generator=gen) * 300 + 1], -1)
    rois[0, :len(chip_smoke.EDGE_ROIS_800)] = torch.tensor(chip_smoke.EDGE_ROIS_800)
    return feats, rois, assign_levels(rois)


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pixels_read_are_the_pixels_with_a_gradient(windowed, dtype):
    feats, rois, levels = _inputs(dtype)
    window = None
    if windowed:
        window = window_lib.Window.of(SHAPES, feats[0].shape[1], feats[0].element_size())
    scales = 1.0 / torch.tensor(ROI_STRIDES, dtype=torch.float32)
    leaves = [f.float().requires_grad_() for f in feats]
    for b in range(rois.shape[0]):
        _align([f[b] for f in leaves], rois[b], levels[b], scales, 7, 2, window).sum().backward()
    touched = sum(int((f.grad.abs().sum(dim=1) > 0).sum()) for f in leaves)
    pixels = chip_smoke.roi_pixels_read(feats, rois, levels, window)
    assert pixels == touched
    assert 0 < pixels < rois.shape[0] * sum(h * w for h, w in SHAPES)


def test_bound_counts_the_pixels_read():
    feats, rois, levels = _inputs(torch.bfloat16)
    bound = chip_smoke.roi_bound(feats, rois, levels, images=rois.shape[0])
    channels, out = feats[0].shape[1], rois.numel() // 4 * feats[0].shape[1] * 49
    want = 2 * channels * bound["pixels_read"] + 4 * (out + rois.numel())
    assert bound["mbytes"] * 1e6 == pytest.approx(want)
    assert bound["bound_ms"] < bound["whole_pyramid_bound_ms"]
