"""Static-shape NMS, the counterpart of `objectpermanence_tpu/ops/nms.py`.

The JAX version is XLA, not a Pallas kernel; on a card the greedy walk is
the kernel of `csrc/nms.cu`, elsewhere plain PyTorch. Every function
takes any leading batch dimensions (the JAX package `vmap`s them), so one
call covers every (image, level) pair of a chunk.

Ties go to the lower index, as `jax.lax.top_k` and the stable `jnp.argsort`
order them: `torch.topk` promises no order for ties, so the sorts here are
`torch.sort(..., descending=True, stable=True)`.
"""

import ctypes

import torch

from objectpermanence_tpu_torch.ops import _build
from objectpermanence_tpu_torch.ops.boxes import pairwise_iou_xyxy

NEG_INF = -1e10


def _sort_desc(scores: torch.Tensor) -> torch.Tensor:
    """Indices of `scores` in descending order along the last dimension,
    ties lower index first."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, *rest) at idx (..., k) along the N dimension."""
    rest = x.shape[idx.dim():]
    index = idx.reshape(*idx.shape, *([1] * len(rest))).expand(*idx.shape, *rest)
    return torch.gather(x, idx.dim() - 1, index)


def _fixed_point(sorted_boxes: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    """The plain greedy NMS of rows (R, N, 4) sorted by score -> keep (R, N):
    each round is one matrix-vector step over every row, and the host checks
    once per round whether any row changed (a converged row stays as it
    is). At most N rounds, as in JAX."""
    n = sorted_boxes.shape[-2]
    iou = pairwise_iou_xyxy(sorted_boxes, sorted_boxes)
    idx = torch.arange(n, device=sorted_boxes.device)
    # overlap[j, i]: j precedes i in score order and suppresses it
    overlap = ((iou > iou_threshold) & (idx[:, None] < idx[None, :])).to(torch.float32)

    keep, prev = valid, torch.zeros_like(valid)
    for _ in range(n):
        if not bool((keep != prev).any()):
            break
        suppressed = torch.bmm(keep.to(torch.float32)[:, None, :], overlap)[:, 0] > 0
        keep, prev = valid & ~suppressed, keep
    return keep


def _greedy_kernel():
    """`csrc/nms.cu`'s entry, built on first use."""
    if not hasattr(_greedy_kernel, "fn"):
        fn = _build.load("nms").nms_greedy_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _greedy_kernel.fn = fn
    return _greedy_kernel.fn


def _greedy(sorted_boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """`_fixed_point`'s mask from the kernel of `csrc/nms.cu`: one block a
    row walks the boxes in order on the card, and the host waits for
    nothing. Rows (R, N, 4) float32 on a card."""
    rows, n = valid.shape
    keep = torch.empty((rows, n), dtype=torch.bool, device=valid.device)
    if rows and n:
        with torch.cuda.device(valid.device):
            err = _greedy_kernel()(sorted_boxes.contiguous().data_ptr(),
                                   valid.contiguous().data_ptr(), keep.data_ptr(), rows, n,
                                   iou_threshold, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"nms kernel launch failed: cudaError {err}")
        nms_mask.launches += 1
    return keep


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask, in the input order.

    boxes (..., N, 4) xyxy, scores (..., N); entries with score <= NEG_INF/10
    are padding. Highest score first, a box is suppressed if it overlaps an
    already-kept box with IoU > iou_threshold (strictly). Greedy NMS is the
    fixed point of keep[i] = valid[i] and not any(j < i, overlap[j, i],
    keep[j]), one for every row of the batch. float32 boxes on a card go to
    the kernel (`_greedy`, counted in `nms_mask.launches`); any others to
    the plain rounds (`_fixed_point`)."""
    n = boxes.shape[-2]
    lead = scores.shape[:-1]
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    order = _sort_desc(scores)
    sorted_boxes = _take(boxes, order)
    valid = torch.gather(scores, 1, order) > NEG_INF / 10
    if boxes.is_cuda and boxes.dtype == torch.float32:
        keep = _greedy(sorted_boxes, valid, iou_threshold)
    else:
        keep = _fixed_point(sorted_boxes, valid, iou_threshold)
    out = torch.zeros_like(keep).scatter_(1, order, keep)
    return out.reshape(*lead, n)


nms_mask.launches = 0


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    """Per-class NMS by the coordinate-offset trick (torchvision
    `batched_nms`): each class is shifted past the largest valid coordinate
    of its batch row, so no suppression crosses classes."""
    coord = torch.where(scores > NEG_INF / 10, boxes.amax(dim=-1),
                        torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    max_coord = coord.amax(dim=-1, keepdim=True)
    offsets = labels.to(boxes.dtype) * (max_coord + 1.0)
    return nms_mask(boxes + offsets[..., None], scores, iou_threshold)


def top_k_by_score(boxes, scores, k: int, *extras):
    """Fixed-size top-k along the last dimension of `scores`: returns
    (boxes (..., k, 4), scores (..., k), *extras (..., k)); rows with fewer
    than k valid entries keep their NEG_INF padding."""
    k = min(k, scores.shape[-1])
    idx = _sort_desc(scores)[..., :k]
    return (_take(boxes, idx), torch.gather(scores, -1, idx),
            *(_take(extra, idx) for extra in extras))
