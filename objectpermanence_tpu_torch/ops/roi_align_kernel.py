"""Multilevel RoIAlign: the CUDA kernels `csrc/roi_align.cu`, their entry
points and plain versions, and the autograd Function that ties the forward
to its backward.

Counterparts of `objectpermanence_tpu/ops/pallas_roi_align.py`:

- `roi_align_batched` (K7, `roi_align_pallas_batched`): the whole batch,
  features `[(B, C, H_l, W_l)]`, rois `(B, N, 4)`, levels `(B, N)`
  -> `(B, N, C, pooled, pooled)`, as `vmap(multilevel_roi_align)` gives it.
- `roi_align_single` (K5, `roi_align_pallas`) and `roi_align_tiled` (K6,
  `roi_align_pallas_tiled`): one image, features `[(C, H_l, W_l)]`, rois
  `(N, 4)`, levels `(N,)` -> `(N, C, pooled, pooled)`; the same kernel with
  B=1. The TPU kernels' tiling arguments (`channel_chunk`, `r_blk`) have no
  meaning here and are not taken.
- `roi_align_batched_backward` (K8, `_pallas_roi_align_tiled_batched_bwd`):
  K7's transpose in the features, `dOut (B, N, C, pooled, pooled)` ->
  `[(B, C, H_l, W_l)]`; rois and levels get no gradient, as the callers'
  `stop_gradient`s give them none in JAX.
- `roi_align_trainable` (`_tiled_batched_diff`, the custom VJP): K7 forward,
  K8 backward, under `RoIAlignFunction`.

Each entry point counts its own launches. On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs the plain version,
`ops/roi_align.py::multilevel_roi_align` (per image) and
`multilevel_roi_align_backward`. fp32 only.

The kernel reads each level NHWC-contiguous: a level in channels_last memory
format is passed as it is; any other layout, such as the detector's NCHW
pyramid, costs one copy of the level (at the detector's native shape, the
209 MB of P2-P5 read and written once per chunk). K8 accumulates into zeroed
NHWC buffers and copies them back to contiguous NCHW, the layout of the
levels it is the gradient of.
"""

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from objectpermanence_tpu_torch.ops import _build
from objectpermanence_tpu_torch.ops.roi_align import (
    multilevel_roi_align, multilevel_roi_align_backward,
)

MAX_LEVELS = 5
MAX_POOLED = 9            # the output tile, 128 x pooled^2 floats, fits 48 KB
MAX_SAMPLES = 32          # pooled * sampling_ratio per axis

_FNS = {}


def _kernel(name: str = "roi_align_forward_f32"):
    """The C entry `name` of the library (forward or backward; both take the
    same arguments)."""
    if name not in _FNS:
        fn = getattr(_build.load("roi_align"), name)
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _level_args(nhwc: List[torch.Tensor], strides: Sequence[int]):
    """ctypes arrays of the NHWC levels' pointers, heights, widths and 1/stride
    (in float32, as the plain version computes it)."""
    num = len(nhwc)
    return ((ctypes.c_void_p * num)(*[f.data_ptr() for f in nhwc]),
            (ctypes.c_int * num)(*[f.shape[1] for f in nhwc]),
            (ctypes.c_int * num)(*[f.shape[2] for f in nhwc]),
            (ctypes.c_float * num)(*[float(np.float32(1.0) / np.float32(s)) for s in strides]),
            num)


def _check(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
           strides: Sequence[int], pooled: int, sampling_ratio: int, image_dims: int):
    """Raise on what the kernel does not take. `image_dims` is 4 for
    batched features (B, C, H, W), 3 for one image's (C, H, W)."""
    if not features or len(features) > MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {len(features)}")
    if len(strides) != len(features):
        raise ValueError(f"{len(features)} levels but {len(strides)} strides")
    for name, x in [("rois", rois), ("levels", levels)] + [
            (f"features[{i}]", f) for i, f in enumerate(features)]:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.device != rois.device:
            raise ValueError(f"{name} is on {x.device}, rois on {rois.device}")
    for i, f in enumerate(features):
        if f.dtype != torch.float32:
            raise TypeError(f"features[{i}] must be float32, got {f.dtype}")
        if f.dim() != image_dims or f.shape[:-2] != features[0].shape[:-2]:
            raise ValueError(f"features[{i}] must be {'(B, C, H, W)' if image_dims == 4 else '(C, H, W)'}"
                             f" with the B and C of features[0], got {tuple(f.shape)}")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    if levels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"levels must be int32 or int64, got {levels.dtype}")
    lead = tuple(features[0].shape[:1]) if image_dims == 4 else ()
    if rois.dim() != len(lead) + 2 or tuple(rois.shape[:len(lead)]) != lead \
            or rois.shape[-1] != 4 or tuple(levels.shape) != tuple(rois.shape[:-1]):
        raise ValueError(f"rois must be {lead + ('N', 4)} and levels {lead + ('N',)}, got "
                         f"{tuple(rois.shape)} and {tuple(levels.shape)}")
    if not (1 <= pooled <= MAX_POOLED and sampling_ratio >= 1
            and pooled * sampling_ratio <= MAX_SAMPLES):
        raise ValueError(f"the kernel takes pooled <= {MAX_POOLED} and pooled * "
                         f"sampling_ratio <= {MAX_SAMPLES}, got {pooled}, {sampling_ratio}")


def _launch(features, rois, levels, strides, pooled, sampling_ratio):
    """The kernel on (B, C, H, W) levels, (B, N, 4) rois, (B, N) levels."""
    if rois.device.type != "cuda":
        raise ValueError(f"the RoIAlign kernel runs on cuda, got {rois.device}")
    batch, channels = features[0].shape[:2]
    n = rois.shape[1]
    out = torch.empty((batch, n, channels, pooled, pooled), dtype=torch.float32,
                      device=rois.device)
    if batch == 0 or n == 0 or channels == 0:
        return out
    # NHWC views; free when a level is channels_last already
    nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in features]
    rois = rois.contiguous()
    levels = levels.to(torch.int32).contiguous()
    fn = _kernel()
    with torch.cuda.device(rois.device):
        err = fn(*_level_args(nhwc, strides), rois.data_ptr(), levels.data_ptr(),
                 out.data_ptr(), batch, n, channels, pooled, sampling_ratio,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: cudaError {err}")
    return out


def roi_align_batched_reference(features: List[torch.Tensor], rois: torch.Tensor,
                                levels: torch.Tensor, strides: Sequence[int],
                                pooled: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """Plain PyTorch K7: `multilevel_roi_align` image by image, on any device."""
    return torch.stack([
        multilevel_roi_align([f[b] for f in features], rois[b], levels[b], strides, pooled,
                             sampling_ratio)
        for b in range(rois.shape[0])])


def roi_align_batched(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
                      strides: Sequence[int], pooled: int = 7,
                      sampling_ratio: int = 2) -> torch.Tensor:
    """K7. features [(B, C, H_l, W_l)], rois (B, N, 4) xyxy image
    coordinates, levels (B, N) -> (B, N, C, pooled, pooled)."""
    _check(features, rois, levels, strides, pooled, sampling_ratio, image_dims=4)
    if rois.device.type == "cpu":
        return roi_align_batched_reference(features, rois, levels, strides, pooled,
                                           sampling_ratio)
    out = _launch(features, rois, levels, strides, pooled, sampling_ratio)
    roi_align_batched.launches += bool(out.numel())  # an empty output launches nothing
    return out


def _one_image(features, rois, levels, strides, pooled, sampling_ratio):
    return _launch([f[None] for f in features], rois[None], levels[None], strides, pooled,
                   sampling_ratio)[0]


def roi_align_single(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
                     strides: Sequence[int], pooled: int = 7,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """K5. features [(C, H_l, W_l)], rois (N, 4), levels (N,)
    -> (N, C, pooled, pooled), matching `multilevel_roi_align`."""
    _check(features, rois, levels, strides, pooled, sampling_ratio, image_dims=3)
    if rois.device.type == "cpu":
        return multilevel_roi_align(features, rois, levels, strides, pooled, sampling_ratio)
    out = _one_image(features, rois, levels, strides, pooled, sampling_ratio)
    roi_align_single.launches += bool(out.numel())  # an empty output launches nothing
    return out


def roi_align_tiled(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
                    strides: Sequence[int], pooled: int = 7,
                    sampling_ratio: int = 2) -> torch.Tensor:
    """K6, the same function as K5 (the TPU kernel tiled 8 rois per step;
    this one is K7's kernel with B=1)."""
    _check(features, rois, levels, strides, pooled, sampling_ratio, image_dims=3)
    if rois.device.type == "cpu":
        return multilevel_roi_align(features, rois, levels, strides, pooled, sampling_ratio)
    out = _one_image(features, rois, levels, strides, pooled, sampling_ratio)
    roi_align_tiled.launches += bool(out.numel())  # an empty output launches nothing
    return out


def _check_backward(grad: torch.Tensor, rois: torch.Tensor, levels: torch.Tensor,
                    shapes: Sequence[Sequence[int]], strides: Sequence[int],
                    sampling_ratio: int):
    """Raise on what K8 does not take: `grad (B, N, C, p, p)` float32 with
    the rois' B and N, and one (H, W) shape per stride."""
    if not isinstance(grad, torch.Tensor) or grad.dtype != torch.float32:
        raise TypeError("grad must be a float32 torch.Tensor")
    if grad.dim() != 5 or grad.shape[-1] != grad.shape[-2] or tuple(grad.shape[:2]) != tuple(
            rois.shape[:2]):
        raise ValueError(f"grad must be (B, N, C, p, p) with the rois' (B, N) = "
                         f"{tuple(rois.shape[:2])}, got {tuple(grad.shape)}")
    if grad.device != rois.device or levels.device != rois.device:
        raise ValueError(f"grad on {grad.device}, rois on {rois.device}, levels on "
                         f"{levels.device}")
    if len(shapes) != len(strides) or not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} level shapes, one per stride; got {len(shapes)} "
                         f"shapes and {len(strides)} strides")
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"rois must be float32 (B, N, 4), got {rois.dtype} {tuple(rois.shape)}")
    if levels.dtype not in (torch.int32, torch.int64) or levels.shape != rois.shape[:2]:
        raise ValueError(f"levels must be int (B, N), got {levels.dtype} {tuple(levels.shape)}")
    pooled = grad.shape[-1]
    if not (1 <= pooled <= MAX_POOLED and sampling_ratio >= 1
            and pooled * sampling_ratio <= MAX_SAMPLES):
        raise ValueError(f"the kernel takes pooled <= {MAX_POOLED} and pooled * "
                         f"sampling_ratio <= {MAX_SAMPLES}, got {pooled}, {sampling_ratio}")


def roi_align_batched_backward_reference(grad: torch.Tensor, rois: torch.Tensor,
                                         levels: torch.Tensor,
                                         shapes: Sequence[Sequence[int]],
                                         strides: Sequence[int],
                                         sampling_ratio: int = 2) -> List[torch.Tensor]:
    """Plain PyTorch K8: `multilevel_roi_align_backward` image by image (an
    explicit `index_add_` scatter), on any device."""
    per_image = [multilevel_roi_align_backward(grad[b], shapes, rois[b], levels[b], strides,
                                               sampling_ratio)
                 for b in range(rois.shape[0])]
    return [torch.stack(level) for level in zip(*per_image)]


def roi_align_batched_backward(grad: torch.Tensor, rois: torch.Tensor, levels: torch.Tensor,
                               shapes: Sequence[Sequence[int]], strides: Sequence[int],
                               sampling_ratio: int = 2) -> List[torch.Tensor]:
    """K8. dOut `grad (B, N, C, p, p)`, the forward's rois (B, N, 4) and
    levels (B, N), and the levels' `shapes [(H_l, W_l)]` -> the features'
    gradient `[(B, C, H_l, W_l)]`, contiguous NCHW (the kernel's NHWC
    buffers, copied)."""
    _check_backward(grad, rois, levels, shapes, strides, sampling_ratio)
    if rois.device.type == "cpu":
        return roi_align_batched_backward_reference(grad, rois, levels, shapes, strides,
                                                    sampling_ratio)
    batch, n, channels, pooled = grad.shape[:4]
    nhwc = [torch.zeros((batch, h, w, channels), dtype=torch.float32, device=grad.device)
            for h, w in shapes]
    if grad.numel():  # an empty dOut launches nothing
        grad = grad.contiguous()
        rois = rois.contiguous()
        levels = levels.to(torch.int32).contiguous()
        fn = _kernel("roi_align_backward_f32")
        with torch.cuda.device(rois.device):
            err = fn(*_level_args(nhwc, strides), rois.data_ptr(), levels.data_ptr(),
                     grad.data_ptr(), batch, n, channels, pooled, sampling_ratio,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"roi_align backward kernel launch failed: cudaError {err}")
        roi_align_batched_backward.launches += 1
    return [g.permute(0, 3, 1, 2).contiguous() for g in nhwc]


class RoIAlignFunction(torch.autograd.Function):
    """K7 forward, K8 backward (the plain versions of both on the CPU). The
    gradient reaches the features only."""

    @staticmethod
    def forward(ctx, rois, levels, strides, pooled, sampling_ratio, *features):
        ctx.save_for_backward(rois, levels)
        ctx.strides, ctx.sampling_ratio = tuple(strides), sampling_ratio
        ctx.shapes = [tuple(f.shape[-2:]) for f in features]
        return roi_align_batched(list(features), rois, levels, strides, pooled, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        dfeatures = roi_align_batched_backward(grad.contiguous(), rois, levels, ctx.shapes,
                                               ctx.strides, ctx.sampling_ratio)
        return (None, None, None, None, None, *dfeatures)


def roi_align_trainable(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
                        strides: Sequence[int], pooled: int = 7,
                        sampling_ratio: int = 2) -> torch.Tensor:
    """K7 with K8 as its backward: `roi_align_batched`'s function, with a
    gradient for the features. Rois and levels are taken as constants."""
    _check(features, rois, levels, strides, pooled, sampling_ratio, image_dims=4)
    return RoIAlignFunction.apply(rois.detach(), levels.detach(), tuple(strides), pooled,
                                  sampling_ratio, *features)


roi_align_batched.launches = 0
roi_align_single.launches = 0
roi_align_tiled.launches = 0
roi_align_batched_backward.launches = 0
