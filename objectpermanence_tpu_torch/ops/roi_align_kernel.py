"""Multilevel RoIAlign: the CUDA kernel `csrc/roi_align.cu`, its entry
points and their plain version.

Counterparts of `objectpermanence_tpu/ops/pallas_roi_align.py`:

- `roi_align_batched` (K7, `roi_align_pallas_batched`): the whole batch,
  features `[(B, C, H_l, W_l)]`, rois `(B, N, 4)`, levels `(B, N)`
  -> `(B, N, C, pooled, pooled)`, as `vmap(multilevel_roi_align)` gives it.
- `roi_align_single` (K5, `roi_align_pallas`) and `roi_align_tiled` (K6,
  `roi_align_pallas_tiled`): one image, features `[(C, H_l, W_l)]`, rois
  `(N, 4)`, levels `(N,)` -> `(N, C, pooled, pooled)`; the same kernel with
  B=1. The TPU kernels' tiling arguments (`channel_chunk`, `r_blk`) have no
  meaning here and are not taken.

Each entry point counts its own launches. On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs the plain version,
`ops/roi_align.py::multilevel_roi_align` (per image). fp32 only.

The kernel reads each level NHWC-contiguous: a level in channels_last memory
format is passed as it is; any other layout, such as the detector's NCHW
pyramid, costs one copy of the level (at the detector's native shape, the
209 MB of P2-P5 read and written once per chunk).
"""

import ctypes
from typing import List, Sequence

import numpy as np
import torch

from objectpermanence_tpu_torch.ops import _build
from objectpermanence_tpu_torch.ops.roi_align import multilevel_roi_align

MAX_LEVELS = 5
MAX_POOLED = 9            # the output tile, 128 x pooled^2 floats, fits 48 KB
MAX_SAMPLES = 32          # pooled * sampling_ratio per axis

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("roi_align").roi_align_forward_f32
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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
    num = len(nhwc)
    pointers = (ctypes.c_void_p * num)(*[f.data_ptr() for f in nhwc])
    heights = (ctypes.c_int * num)(*[f.shape[1] for f in nhwc])
    widths = (ctypes.c_int * num)(*[f.shape[2] for f in nhwc])
    # 1/stride in float32, as the plain version computes it
    scales = (ctypes.c_float * num)(*[float(np.float32(1.0) / np.float32(s)) for s in strides])
    fn = _kernel()
    with torch.cuda.device(rois.device):
        err = fn(pointers, heights, widths, scales, num, rois.data_ptr(), levels.data_ptr(),
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


roi_align_batched.launches = 0
roi_align_single.launches = 0
roi_align_tiled.launches = 0
