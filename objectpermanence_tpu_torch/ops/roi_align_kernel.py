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
  `[(B, C, H_l, W_l)]` in float32 or, for bfloat16 features, bfloat16;
  rois and levels get no gradient, as the callers' `stop_gradient`s give
  them none in JAX.
- `roi_align_trainable` (`_tiled_batched_diff`, the custom VJP): K7 forward,
  K8 backward, under `RoIAlignFunction`.
- `roi_align_windowed` (K9, `roi_align_pallas_windowed`): K7's function
  with the taps outside each roi's window dropped (`ops/roi_align_window.py`),
  counting its out-of-contract rois.
- `roi_align_windowed_trainable` (`roi_align_windowed_trainable`): K9
  forward, K8 backward (the exact function's transpose, as JAX's backward
  is the VJP of its gather), under `RoIAlignFunction`. A roi out of the
  window contract so gets a gradient of taps its forward dropped, as in JAX.

Each entry point counts its own launches. On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs the plain version,
`ops/roi_align.py::multilevel_roi_align` (per image),
`multilevel_roi_align_backward` and
`ops/roi_align_window.py::multilevel_roi_align_windowed`. The forwards take
float32 or bfloat16 features and return float32 (the plain versions read
bfloat16 as float32). K8 sums the float32 cotangent with float32 weights
into float32 buffers in both modes; for bfloat16 features dF is rounded to
bfloat16 once, in the copy out of those buffers. JAX's bf16 K8 instead
rounds its interpolation weights and its first product to bf16
(`pallas_roi_align.py:784-787, 839`); the port keeps them float32, as its
bf16 forwards do, and as JAX's gather VJP does.

The forward kernels read each level in place through its element strides:
the detector's NCHW pyramid, a channels_last one or any other view, with no
copy (`launch_plan` sets their launch). K8 accumulates into zeroed NHWC
buffers and copies them back to contiguous NCHW, the layout of the levels it
is the gradient of, casting to the features' dtype in the same copy.
"""

import ctypes
import functools
from typing import List, Sequence

import numpy as np
import torch

from objectpermanence_tpu_torch.ops import _build
from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
from objectpermanence_tpu_torch.ops.roi_align import (
    multilevel_roi_align, multilevel_roi_align_backward,
)

MAX_LEVELS = 5
MAX_POOLED = 9            # K8's output tile, 128 x pooled^2 floats, fits 48 KB
MAX_SAMPLES = 32          # pooled * sampling_ratio per axis
# The forward's launch (csrc/roi_align.cu): threads a block, the most channels
# a block takes, and the shared memory a pass of channels may use, so that
# three blocks share an SM at 7 x 2.
FORWARD_THREADS = 256
FORWARD_SLICE = 256
TILE_BYTES = 64 * 1024
SMEM_PER_BLOCK = 232448   # 227 KB: the most shared memory a block may have
STATIC_SMEM = 2320        # the kernel's SampleTable and CompactTile, as ptxas lays them out

_FNS = {}


def _tile_pitch(pixels: int) -> int:
    """The kernel's tile holds channels in pairs, a pair's pixels at an odd
    pitch (`csrc/roi_align.cu::tile_pitch`)."""
    return pixels | 1


def _pass_bytes(channels: int, pitch: int, itemsize: int, bins: int) -> int:
    """Shared memory of a pass of `channels` channels: their tile, then
    their float32 output (`csrc/roi_align.cu::pass_bytes`)."""
    return -(-((channels + 1) // 2 * pitch * 2 * itemsize) // 16) * 16 + channels * bins * 4


def launch_plan(channels: int, pooled: int, sampling_ratio: int, itemsize: int) -> dict:
    """How the forward kernel (K5-K7, K9) is launched for `channels`
    channels of `itemsize` bytes (4: float32, 2: bfloat16) at `pooled` x
    `sampling_ratio`: `slice`, the channels of a block, and `blocks`, the
    slices that cover `channels`; `threads` a block; `smem`, its dynamic
    shared memory (the sample and pixel tables, then `tile_bytes` for its
    passes, which hold at least a pair of channels of the largest tile, 2k x
    2k pixels for k = pooled * sampling_ratio). Raises on what does not
    fit."""
    if channels < 1 or itemsize not in (2, 4):
        raise ValueError(f"the kernel takes channels >= 1 of 2 or 4 bytes, got {channels}, "
                         f"{itemsize}")
    if not (1 <= pooled <= MAX_POOLED and sampling_ratio >= 1
            and pooled * sampling_ratio <= MAX_SAMPLES):
        raise ValueError(f"the kernel takes pooled <= {MAX_POOLED} and pooled * "
                         f"sampling_ratio <= {MAX_SAMPLES}, got {pooled}, {sampling_ratio}")
    k = pooled * sampling_ratio
    largest = _pass_bytes(2, _tile_pitch(4 * k * k), itemsize, pooled * pooled)
    tile_bytes = max(TILE_BYTES, largest)
    smem = 40 * k * k + tile_bytes
    if smem + STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f"pooled {pooled} x {sampling_ratio} needs {smem + STATIC_SMEM} bytes "
                         f"of shared memory, more than a block's {SMEM_PER_BLOCK}")
    slice_ = min(channels, FORWARD_SLICE)
    return {"slice": slice_, "blocks": -(-channels // slice_), "threads": FORWARD_THREADS,
            "smem": smem, "tile_bytes": tile_bytes}


def last_plan() -> dict:
    """The plan and grid of the last forward launch, as the library recorded
    them (the card only)."""
    out = (ctypes.c_int * 5)()
    _build.load("roi_align").roi_align_forward_last_plan(out)
    return dict(zip(("slice", "threads", "smem", "tile_bytes", "blocks"), out))


def _kernel(name: str = "roi_align_forward_f32"):
    """The C entry `name` of the library. The forwards take the levels'
    strides after their scales and the plan after the sampling ratio; the
    windowed forwards add the window (three ints) and the out-of-contract
    count's pointer before the stream."""
    if name not in _FNS:
        fn = getattr(_build.load("roi_align"), name)
        levels = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)]
        if "forward" in name:
            window = [ctypes.c_int] * 3 + [ctypes.c_void_p] if "windowed" in name else []
            fn.argtypes = (levels + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] + window
                           + [ctypes.c_void_p])
        else:
            fn.argtypes = (levels + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _scales(strides: Sequence[int]):
    """1/stride of each level in float32, as the plain version computes it."""
    return (ctypes.c_float * len(strides))(
        *[float(np.float32(1.0) / np.float32(s)) for s in strides])


def _level_args(nhwc: List[torch.Tensor], strides: Sequence[int]):
    """ctypes arrays of K8's NHWC levels' pointers, heights, widths and
    scales."""
    num = len(nhwc)
    return ((ctypes.c_void_p * num)(*[f.data_ptr() for f in nhwc]),
            (ctypes.c_int * num)(*[f.shape[1] for f in nhwc]),
            (ctypes.c_int * num)(*[f.shape[2] for f in nhwc]), _scales(strides), num)


def _forward_args(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
                  strides: Sequence[int], pooled: int, sampling_ratio: int,
                  out: torch.Tensor, plan: dict):
    """The forward C entry's arguments up to the window: the (B, C, H, W)
    levels as they lie in memory (pointers, heights, widths, scales, element
    strides), rois, int32 levels, the output, the sizes and the plan."""
    for i, f in enumerate(features):
        sy, sx = f.stride()[2:]
        if (f.shape[2] - 1) * sy + (f.shape[3] - 1) * sx >= 2 ** 31:
            raise ValueError(f"features[{i}]: a plane's offsets exceed 32 bits (strides "
                             f"{f.stride()})")
    num = len(features)
    batch, channels = features[0].shape[:2]
    return ((ctypes.c_void_p * num)(*[f.data_ptr() for f in features]),
            (ctypes.c_int * num)(*[f.shape[2] for f in features]),
            (ctypes.c_int * num)(*[f.shape[3] for f in features]), _scales(strides),
            (ctypes.c_longlong * (4 * num))(*[st for f in features for st in f.stride()]),
            num, rois.data_ptr(), levels.data_ptr(), out.data_ptr(), batch, rois.shape[1],
            channels, pooled, sampling_ratio,
            (ctypes.c_int * 4)(plan["slice"], plan["threads"], plan["smem"], plan["tile_bytes"]))


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
        if f.dtype not in (torch.float32, torch.bfloat16) or f.dtype != features[0].dtype:
            raise TypeError(f"features must be all float32 or all bfloat16, got {f.dtype} "
                            f"for features[{i}] and {features[0].dtype} for features[0]")
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


def _launch(features, rois, levels, strides, pooled, sampling_ratio, window=None,
            out_of_contract=None):
    """The forward kernel on (B, C, H, W) levels, (B, N, 4) rois, (B, N)
    levels: K7's, or K9's with a `Window` (and the count its out-of-contract
    rois add to, or None)."""
    if rois.device.type != "cuda":
        raise ValueError(f"the RoIAlign kernel runs on cuda, got {rois.device}")
    batch, channels = features[0].shape[:2]
    n = rois.shape[1]
    out = torch.empty((batch, n, channels, pooled, pooled), dtype=torch.float32,
                      device=rois.device)
    if batch == 0 or n == 0 or channels == 0:
        return out
    rois = rois.contiguous()
    levels = levels.to(torch.int32).contiguous()
    dtype = "bf16" if features[0].dtype == torch.bfloat16 else "f32"
    plan = launch_plan(channels, pooled, sampling_ratio, features[0].element_size())
    if window is None:
        fn, extra = _kernel(f"roi_align_forward_{dtype}"), []
    else:
        fn = _kernel(f"roi_align_windowed_forward_{dtype}")
        extra = [window.size, window.y_quant, window.x_quant,
                 None if out_of_contract is None else out_of_contract.data_ptr()]
    with torch.cuda.device(rois.device):
        err = fn(*_forward_args(features, rois, levels, strides, pooled, sampling_ratio, out,
                                plan), *extra, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: cudaError {err}")
    return out


def roi_align_batched_reference(features: List[torch.Tensor], rois: torch.Tensor,
                                levels: torch.Tensor, strides: Sequence[int],
                                pooled: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """Plain PyTorch K7: `multilevel_roi_align` image by image, on any
    device; bfloat16 features are read as float32."""
    return torch.stack([
        multilevel_roi_align([f[b].float() for f in features], rois[b], levels[b], strides,
                             pooled, sampling_ratio)
        for b in range(rois.shape[0])])


def roi_align_batched(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
                      strides: Sequence[int], pooled: int = 7,
                      sampling_ratio: int = 2) -> torch.Tensor:
    """K7. features [(B, C, H_l, W_l)] float32 or bfloat16, rois (B, N, 4)
    xyxy image coordinates, levels (B, N) -> (B, N, C, pooled, pooled)
    float32."""
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
                    sampling_ratio: int, dtype: torch.dtype):
    """Raise on what K8 does not take: `grad (B, N, C, p, p)` float32 with
    the rois' B and N, one (H, W) shape per stride, and dF in float32 or
    bfloat16."""
    if not isinstance(grad, torch.Tensor) or grad.dtype != torch.float32:
        raise TypeError("grad must be a float32 torch.Tensor")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dF's dtype must be torch.float32 or torch.bfloat16, got {dtype}")
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
                                         strides: Sequence[int], sampling_ratio: int = 2,
                                         dtype: torch.dtype = torch.float32
                                         ) -> List[torch.Tensor]:
    """Plain PyTorch K8: `multilevel_roi_align_backward` image by image (an
    explicit `index_add_` scatter, in float32), on any device, then cast to
    `dtype`."""
    per_image = [multilevel_roi_align_backward(grad[b], shapes, rois[b], levels[b], strides,
                                               sampling_ratio)
                 for b in range(rois.shape[0])]
    return [torch.stack(level).to(dtype) for level in zip(*per_image)]


def roi_align_batched_backward(grad: torch.Tensor, rois: torch.Tensor, levels: torch.Tensor,
                               shapes: Sequence[Sequence[int]], strides: Sequence[int],
                               sampling_ratio: int = 2,
                               dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """K8. dOut `grad (B, N, C, p, p)`, the forward's rois (B, N, 4) and
    levels (B, N), and the levels' `shapes [(H_l, W_l)]` -> the features'
    gradient `[(B, C, H_l, W_l)]` in `dtype` (the features' own: float32 or
    bfloat16), contiguous NCHW: the kernel's float32 NHWC buffers, copied
    and cast in one pass."""
    _check_backward(grad, rois, levels, shapes, strides, sampling_ratio, dtype)
    if rois.device.type == "cpu":
        return roi_align_batched_backward_reference(grad, rois, levels, shapes, strides,
                                                    sampling_ratio, dtype)
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
    return [nchw_copy(g, dtype) for g in nhwc]


def nchw_copy(nhwc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K8's buffer `nhwc (B, H, W, C)` as a contiguous NCHW tensor in
    `dtype`, in one copy (the layout change and the cast together)."""
    batch, height, width, channels = nhwc.shape
    out = torch.empty((batch, channels, height, width), dtype=dtype, device=nhwc.device)
    return out.copy_(nhwc.permute(0, 3, 1, 2))


class RoIAlignFunction(torch.autograd.Function):
    """A RoIAlign forward, `forward(features, rois, levels, strides, pooled,
    sampling_ratio)` (K7 or K9), with K8 as its backward (the plain versions
    of each on the CPU). The gradient reaches the features only, in their
    dtype."""

    @staticmethod
    def forward(ctx, forward, rois, levels, strides, pooled, sampling_ratio, *features):
        ctx.save_for_backward(rois, levels)
        ctx.strides, ctx.sampling_ratio = tuple(strides), sampling_ratio
        ctx.shapes = [tuple(f.shape[-2:]) for f in features]
        ctx.dtype = features[0].dtype
        return forward(list(features), rois, levels, strides, pooled, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        dfeatures = roi_align_batched_backward(grad.contiguous(), rois, levels, ctx.shapes,
                                               ctx.strides, ctx.sampling_ratio, ctx.dtype)
        return (None, None, None, None, None, None, *dfeatures)


def roi_align_trainable(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
                        strides: Sequence[int], pooled: int = 7,
                        sampling_ratio: int = 2) -> torch.Tensor:
    """K7 with K8 as its backward: `roi_align_batched`'s function, with a
    gradient for the features (float32 or bfloat16, dF in their dtype).
    Rois and levels are taken as constants."""
    _check(features, rois, levels, strides, pooled, sampling_ratio, image_dims=4)
    return RoIAlignFunction.apply(roi_align_batched, rois.detach(), levels.detach(),
                                  tuple(strides), pooled, sampling_ratio, *features)


def roi_align_windowed_reference(features: List[torch.Tensor], rois: torch.Tensor,
                                 levels: torch.Tensor, strides: Sequence[int], pooled: int = 7,
                                 sampling_ratio: int = 2, channel_chunk: int = 128,
                                 win: int = 48) -> torch.Tensor:
    """Plain PyTorch K9: `multilevel_roi_align_windowed` image by image, on
    any device (the window follows the features' dtype)."""
    return torch.stack([
        window_lib.multilevel_roi_align_windowed([f[b] for f in features], rois[b], levels[b],
                                                 strides, pooled, sampling_ratio,
                                                 channel_chunk, win)
        for b in range(rois.shape[0])])


def roi_align_windowed(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
                       strides: Sequence[int], pooled: int = 7, sampling_ratio: int = 2,
                       channel_chunk: int = 128, win: int = 48) -> torch.Tensor:
    """K9. As `roi_align_batched`, with each roi read from its window of
    `win` px widened to the features' alignment quanta (`channel_chunk`
    and the dtype set them, `ops/roi_align_window.py`) and the taps outside
    it dropped. Counts every roi slot and, on the device, those out of
    contract (`roi_align_window.contract_stats`) unless
    OP_TPU_ROI_CONTRACT_STATS=0. No gradient."""
    _check(features, rois, levels, strides, pooled, sampling_ratio, image_dims=4)
    counting = window_lib.contract_stats_active()
    if rois.device.type == "cpu":
        out = roi_align_windowed_reference(features, rois, levels, strides, pooled,
                                           sampling_ratio, channel_chunk, win)
        if counting:
            shapes = [tuple(f.shape[-2:]) for f in features]
            mask = window_lib.windowed_out_of_contract_mask(
                rois, levels, [(h, w, s) for (h, w), s in zip(shapes, strides)],
                channels=features[0].shape[1], itemsize=features[0].element_size(),
                pooled=pooled, sampling_ratio=sampling_ratio, channel_chunk=channel_chunk,
                win=win)
            window_lib.out_of_contract_counter(rois.device).add_(mask.sum())
            window_lib.count_dispatch(mask.numel())
        return out
    window = window_lib.Window.of([tuple(f.shape[-2:]) for f in features], features[0].shape[1],
                                  features[0].element_size(), channel_chunk, win)
    counter = window_lib.out_of_contract_counter(rois.device) if counting else None
    out = _launch(features, rois, levels, strides, pooled, sampling_ratio, window, counter)
    if out.numel():  # an empty output launches nothing
        roi_align_windowed.launches += 1
        if counting:
            window_lib.count_dispatch(rois.shape[0] * rois.shape[1])
    return out


def roi_align_windowed_trainable(features: List[torch.Tensor], rois: torch.Tensor,
                                 levels: torch.Tensor, strides: Sequence[int], pooled: int = 7,
                                 sampling_ratio: int = 2, channel_chunk: int = 128,
                                 win: int = 48) -> torch.Tensor:
    """K9 with K8 as its backward, JAX's `roi_align_windowed_trainable`:
    `roi_align_windowed`'s function (its contract counting included), with
    the exact RoIAlign's gradient for the features (float32 or bfloat16, dF
    in their dtype). For a roi out of the window contract the backward so
    keeps the taps the forward dropped, as JAX's does
    (`pallas_roi_align.py:1194-1198`). Rois and levels are constants."""
    _check(features, rois, levels, strides, pooled, sampling_ratio, image_dims=4)
    forward = functools.partial(roi_align_windowed, channel_chunk=channel_chunk, win=win)
    return RoIAlignFunction.apply(forward, rois.detach(), levels.detach(), tuple(strides),
                                  pooled, sampling_ratio, *features)


roi_align_batched.launches = 0
roi_align_windowed.launches = 0
roi_align_single.launches = 0
roi_align_tiled.launches = 0
roi_align_batched_backward.launches = 0
