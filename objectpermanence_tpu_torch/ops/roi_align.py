"""RoIAlign in plain PyTorch, the counterpart of
`objectpermanence_tpu/ops/roi_align.py`, and the plain version of the
RoIAlign kernel (`ops/roi_align_kernel.py`, `csrc/roi_align.cu`).

torchvision semantics with `aligned=False`: each roi's box is scaled to its
level, its sides are at least 1 pixel, and each of the `pooled x pooled`
bins averages `sampling_ratio^2` bilinear samples. A sample outside
[-1, H] x [-1, W] contributes 0; inside, its coordinates are clamped to
[0, H-1] x [0, W-1] and the upper tap to H-1 (W-1).
"""

from typing import List, Sequence, Tuple

import torch


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32 with one rounding, as a fused multiply-add
    gives it (the kernel's `__fmaf_rn`): the product of two float32 values
    is exact in float64, and the float64 sum is rounded to float32."""
    return (a.double() * b.double() + c.double()).float()


def _geometry(shapes: Sequence[Tuple[int, int]], rois: torch.Tensor, levels: torch.Tensor,
              scales: torch.Tensor, pooled: int, sampling_ratio: int):
    """Where each roi's samples fall in the concatenated level table (levels
    `shapes [(H_l, W_l)]`, row-major, one row per pixel): for the N rois'
    k*k samples (k = pooled * sampling_ratio, y-major), the four taps' table
    rows `(N, k*k)` each, their bilinear weights and the inside mask."""
    device = rois.device
    offsets, offset = [], 0
    for h, w in shapes:
        offsets.append(offset)
        offset += h * w
    levels = levels.to(torch.int64)
    base = torch.tensor(offsets, device=device)[levels][:, None]
    h = torch.tensor([s[0] for s in shapes], device=device)[levels][:, None]
    w = torch.tensor([s[1] for s in shapes], device=device)[levels][:, None]
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
    rows = [base + yi * w + xi for yi, xi in ((y0, x0), (y0, x1c), (y1c, x0), (y1c, x1c))]
    weights = [hy * hx, hy * lx, ly * hx, ly * lx]
    return rows, weights, inside


def _align(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
           scales: torch.Tensor, pooled: int, sampling_ratio: int) -> torch.Tensor:
    """RoIAlign of each roi from its level of `features [(C, H_l, W_l)]`,
    with `scales (L,)` float32 taking image coordinates to each level's."""
    c = features[0].shape[0]
    shapes = [tuple(f.shape[1:]) for f in features]
    rows, weights, inside = _geometry(shapes, rois, levels, scales, pooled, sampling_ratio)
    # row-major (S, C) table: one contiguous C-wide row per pixel
    table = torch.cat([f.permute(1, 2, 0).reshape(-1, c) for f in features])
    val = (table[rows[0]] * weights[0][..., None] + table[rows[1]] * weights[1][..., None] +
           table[rows[2]] * weights[2][..., None] + table[rows[3]] * weights[3][..., None])
    val = torch.where(inside[..., None], val, torch.zeros((), dtype=val.dtype, device=val.device))
    n, s = rois.shape[0], sampling_ratio
    val = val.reshape(n, pooled, s, pooled, s, c).mean(dim=(2, 4))
    return val.permute(0, 3, 1, 2)                           # (N, C, p, p)


def _align_backward(grad: torch.Tensor, shapes: Sequence[Tuple[int, int]], rois: torch.Tensor,
                    levels: torch.Tensor, scales: torch.Tensor,
                    sampling_ratio: int) -> List[torch.Tensor]:
    """The transpose of `_align` in the features: `grad (N, C, p, p)` ->
    `[(C, H_l, W_l)]`. Each sample's share of its bin, `grad / s^2`, is
    scattered with `index_add_` onto its four taps' rows, times their
    weights; a sample outside the level adds nothing."""
    n, c, pooled = grad.shape[0], grad.shape[1], grad.shape[2]
    s = sampling_ratio
    rows, weights, inside = _geometry(shapes, rois, levels, scales, pooled, s)
    share = (grad.permute(0, 2, 3, 1)[:, :, None, :, None, :]
             .expand(n, pooled, s, pooled, s, c).reshape(n, (pooled * s) ** 2, c)) * (1.0 / (s * s))
    share = torch.where(inside[..., None], share,
                        torch.zeros((), dtype=share.dtype, device=share.device))
    table = torch.zeros((sum(h * w for h, w in shapes), c), dtype=grad.dtype,
                        device=grad.device)
    for row, weight in zip(rows, weights):
        table.index_add_(0, row.reshape(-1), (share * weight[..., None]).reshape(-1, c))
    out, offset = [], 0
    for h, w in shapes:
        out.append(table[offset:offset + h * w].reshape(h, w, c).permute(2, 0, 1))
        offset += h * w
    return out


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


def multilevel_roi_align_backward(grad: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                                  rois: torch.Tensor, levels: torch.Tensor,
                                  strides: Sequence[int],
                                  sampling_ratio: int = 2) -> List[torch.Tensor]:
    """The gradient of `multilevel_roi_align` in its features: `grad (N, C,
    p, p)`, the levels' `shapes [(H_l, W_l)]` -> `[(C, H_l, W_l)]`. Rois and
    levels get none."""
    scales = 1.0 / torch.tensor(strides, dtype=torch.float32, device=rois.device)
    return _align_backward(grad, shapes, rois, levels, scales, sampling_ratio)
