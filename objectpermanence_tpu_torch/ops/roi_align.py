"""RoIAlign in plain PyTorch, the counterpart of
`objectpermanence_tpu/ops/roi_align.py`, and the plain version of the
RoIAlign kernel (`ops/roi_align_kernel.py`, `csrc/roi_align.cu`).

torchvision semantics with `aligned=False`: each roi's box is scaled to its
level, its sides are at least 1 pixel, and each of the `pooled x pooled`
bins averages `sampling_ratio^2` bilinear samples. A sample outside
[-1, H] x [-1, W] contributes 0; inside, its coordinates are clamped to
[0, H-1] x [0, W-1] and the upper tap to H-1 (W-1).
"""

from typing import List, Sequence

import torch


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32 with one rounding, as a fused multiply-add
    gives it (the kernel's `__fmaf_rn`): the product of two float32 values
    is exact in float64, and the float64 sum is rounded to float32."""
    return (a.double() * b.double() + c.double()).float()


def _align(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
           scales: torch.Tensor, pooled: int, sampling_ratio: int) -> torch.Tensor:
    """RoIAlign of each roi from its level of `features [(C, H_l, W_l)]`,
    with `scales (L,)` float32 taking image coordinates to each level's."""
    c = features[0].shape[0]
    device = rois.device
    offsets, hs, ws = [], [], []
    offset = 0
    for feat in features:
        _, h, w = feat.shape
        offsets.append(offset)
        hs.append(h)
        ws.append(w)
        offset += h * w
    # row-major (S, C) table: one contiguous C-wide row per pixel
    table = torch.cat([f.permute(1, 2, 0).reshape(-1, c) for f in features])

    levels = levels.to(torch.int64)
    base = torch.tensor(offsets, device=device)[levels][:, None]
    h = torch.tensor(hs, device=device)[levels][:, None]
    w = torch.tensor(ws, device=device)[levels][:, None]
    fh, fw = h.to(torch.float32), w.to(torch.float32)

    r = rois.to(torch.float32) * scales[levels][:, None]
    x1, y1 = r[:, 0], r[:, 1]
    roi_w = (r[:, 2] - r[:, 0]).clamp(min=1.0)
    roi_h = (r[:, 3] - r[:, 1]).clamp(min=1.0)
    s = sampling_ratio
    offs = (torch.arange(s, device=device, dtype=torch.float32) + 0.5) / s
    bins = torch.arange(pooled, device=device, dtype=torch.float32)
    grid = (bins[:, None] + offs[None, :]).reshape(-1)       # (k,)
    # XLA turns `/ pooled` into a product with the float32 reciprocal, and
    # `y1 + grid * bin` into one fused multiply-add: the same here
    inv_pooled = torch.tensor(1.0, dtype=torch.float32) / pooled
    ys = _fma(grid[None, :], (roi_h * inv_pooled)[:, None], y1[:, None])
    xs = _fma(grid[None, :], (roi_w * inv_pooled)[:, None], x1[:, None])

    n, k = ys.shape
    yy = ys[:, :, None].expand(n, k, k).reshape(n, k * k)
    xx = xs[:, None, :].expand(n, k, k).reshape(n, k * k)
    inside = (yy >= -1.0) & (yy <= fh) & (xx >= -1.0) & (xx <= fw)
    y = torch.minimum(yy.clamp(min=0.0), fh - 1)
    x = torch.minimum(xx.clamp(min=0.0), fw - 1)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1c = torch.minimum(y0 + 1, h - 1)
    x1c = torch.minimum(x0 + 1, w - 1)
    ly = y - y0
    lx = x - x0
    hy = 1.0 - ly
    hx = 1.0 - lx

    def take(yi, xi):
        return table[base + yi * w + xi]                     # (N, k*k, C)

    val = (take(y0, x0) * (hy * hx)[..., None] +
           take(y0, x1c) * (hy * lx)[..., None] +
           take(y1c, x0) * (ly * hx)[..., None] +
           take(y1c, x1c) * (ly * lx)[..., None])
    val = torch.where(inside[..., None], val, torch.zeros((), dtype=val.dtype, device=device))
    val = val.reshape(n, pooled, s, pooled, s, c).mean(dim=(2, 4))
    return val.permute(0, 3, 1, 2)                           # (N, C, p, p)


def roi_align(features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              pooled: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """features (C, H, W); rois (N, 4) xyxy in image coordinates
    -> (N, C, pooled, pooled)."""
    levels = torch.zeros(rois.shape[0], dtype=torch.int64, device=rois.device)
    scales = torch.tensor([spatial_scale], dtype=torch.float32, device=rois.device)
    return _align([features], rois, levels, scales, pooled, sampling_ratio)


def multilevel_roi_align(features: List[torch.Tensor], rois: torch.Tensor,
                         levels: torch.Tensor, strides: Sequence[int], pooled: int = 7,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """Multi-level RoIAlign with one gather from the concatenated levels:
    each roi samples only its assigned level.

    features: list of (C, H_l, W_l); rois (N, 4) xyxy image coordinates;
    levels (N,) int index into `features`. -> (N, C, pooled, pooled)."""
    scales = 1.0 / torch.tensor(strides, dtype=torch.float32, device=rois.device)
    return _align(features, rois, levels, scales, pooled, sampling_ratio)
