"""Sequence (frame-axis) parallelism, the counterpart of
`objectpermanence_tpu/parallel/sequence.py`.

The batch is split over the mesh's `data` dim and the frames over its
`model` dim: a per-frame stage runs on the rank's `(B/d, T/m, ...)` block
with no communication, and its results are gathered over `model` by
`all_gather`, so the recurrences that follow run on whole sequences. Entry
points:

- `frame_sharded`: lift any frame-local function into such a stage;
- `make_sequence_parallel_iou`: the eval step's per-video IoU sums, summed
  over `model` by an all-reduce (JAX's `psum`);
- `make_sequence_parallel_transformer_forward`: `transformer_lstm` with its
  per-frame encoder over 15 object tokens sharded over frames;
- `make_sequence_parallel_opnet_forward`: OPNet with the attention head,
  softmax and box selection, and the box head, sharded over frames.

Every function takes the global arrays (every rank passes the same ones, as
JAX's callers pass global arrays) and returns the global result on every
rank (the data slices are gathered at the end). It raises when the data
width does not divide the batch or the model width the frames, as
`shard_map` does. The forwards are for inference, as JAX's: no gradient,
the models' layers in eval mode, and on the card the recurrences run on
K4 (`ops/lstm.py::LSTM`). They run stage by stage, so OPNet's fused kernel
(K1) is not used.
"""

import contextlib

import torch
import torch.distributed as dist

from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes, iou_xyxy
from objectpermanence_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_group, axis_slice, axis_width, batch_sharding,
)


def _gather(mesh, axis: str, tensor: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' `tensor`s along the mesh dim `axis`, joined along `dim` in
    rank order."""
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(axis_width(mesh, axis))]
    dist.all_gather(parts, tensor, group=axis_group(mesh, axis))
    return torch.cat(parts, dim=dim)


def _map(fn, out):
    return tuple(fn(o) for o in out) if isinstance(out, tuple) else fn(out)


def _frames(mesh, frames: int) -> slice:
    return axis_slice(mesh, MODEL_AXIS, frames, "frames")


def _stage(mesh, fn):
    """`fn` on the rank's frame block of each of its data rows `(B/d, T, ...)`;
    the results' frames gathered over `model`, `(B/d, T, ...)`."""
    def run(params, *rows):
        frames = _frames(mesh, rows[0].shape[1])
        out = fn(params, *(a[:, frames] for a in rows))
        return _map(lambda o: _gather(mesh, MODEL_AXIS, o, 1), out)
    return run


def _rows(mesh, arrays):
    rows = batch_sharding(mesh, arrays[0].shape[0])
    _frames(mesh, arrays[0].shape[1])
    return [a[rows] for a in arrays]


@contextlib.contextmanager
def _inference(model):
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was)


def frame_sharded(mesh, fn):
    """Lift a frame-local function into a sequence-parallel stage.

    `fn(params, *arrays) -> tensor | tuple of tensors`, every array argument
    and result laid out (batch, frames, ...). The stage runs `fn` on each
    rank's `(B/d, T/m, ...)` block with no communication inside, and
    returns the global results on every rank. `fn` must not mix information
    across frames (per-frame encoders, heads and einsums are fine;
    recurrences are not: run those on gathered sequences between stages).
    `params` is passed whole to every rank."""
    stage = _stage(mesh, fn)

    def wrapped(params, *arrays):
        out = stage(params, *_rows(mesh, arrays))
        return _map(lambda o: _gather(mesh, DATA_AXIS, o, 0), out)

    return wrapped


def make_sequence_parallel_iou(mesh):
    """-> `sp_iou(pred, labels, mask)` -> (per-video mean IoU `(B,)`, IoU
    sum over the masked frames `(B,)`, masked frame count `(B,)`), as
    `train/loop.py::make_eval_step` computes them, over (batch, frames)
    split on (data, model)."""

    @torch.no_grad()
    def sp_iou(pred, labels, mask):
        pred, labels, mask = (a[:, _frames(mesh, a.shape[1])]
                              for a in _rows(mesh, (pred, labels, mask)))
        # the local block: (B/d, T/m, 4); the reference truncates to int32 pixels
        iou = iou_xyxy(denormalize_boxes(pred).float(), denormalize_boxes(labels).float())
        frame_mask = mask.sum(dim=-1) > 0
        sums = torch.stack([iou.sum(dim=1), (iou * frame_mask).sum(dim=1),
                            frame_mask.sum(dim=1).to(iou.dtype),
                            torch.full_like(iou[:, 0], iou.shape[1])])
        dist.all_reduce(sums, group=axis_group(mesh, MODEL_AXIS))
        sums = _gather(mesh, DATA_AXIS, sums, 1)
        return sums[0] / sums[3], sums[1], sums[2]

    return sp_iou


def make_sequence_parallel_transformer_forward(mesh):
    """-> `forward(model, boxes (B, T, 15, 5))` -> `(B, T, 4)`: a
    `TransformerLSTM`'s forward with the per-frame encoder (box projection,
    ReLU, the encoder layers over the 15 object tokens, the snitch's slot)
    and the box head sharded over frames; the stacked LSTM runs on gathered
    frames. The encoder attends within each frame: a model with
    `reference_compat` (attention across the batch) cannot be split over
    frames and raises."""

    def encoder_stage(model, boxes_s):
        b, t, o, _ = boxes_s.shape
        tokens = torch.relu(model.box_proj(boxes_s)).reshape(b * t, o, -1)
        return model.encoder(tokens, slot=0).reshape(b, t, -1)    # the snitch's slot

    encoder_sp = _stage(mesh, encoder_stage)
    head_sp = _stage(mesh, lambda head, h: head(h))

    def forward(model, boxes):
        if model.reference_compat:
            raise ValueError("reference_compat attends across the batch; it cannot be split "
                             "over frames")
        with _inference(model):
            (local,) = _rows(mesh, (boxes,))
            hidden = model.video_lstm(encoder_sp(model, local))
            return _gather(mesh, DATA_AXIS, head_sp(model.box_head, hidden), 0)

    return forward


def make_sequence_parallel_opnet_forward(mesh):
    """-> `forward(model, boxes (B, T, 15, 6))` -> (boxes `(B, T, 4)`,
    who-to-attend logits `(B, 15, T)`), as OPNet's `forward_layers`: the
    attention head, softmax and box selection between the two recurrences,
    and the box head, sharded over frames; the who-to-attend and video
    LSTMs run on gathered frames."""

    def select_stage(att_head, boxes_s, att_h_s):
        logits = att_head(att_h_s)                                  # (b, t/m, 15)
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("btof,bto->btf", boxes_s, probs), logits

    select_sp = _stage(mesh, select_stage)
    head_sp = _stage(mesh, lambda head, h: head(h))

    def forward(model, boxes):
        with _inference(model):
            (local,) = _rows(mesh, (boxes,))
            b, t, o, f = local.shape
            att_h = model.att_lstm(local.reshape(b, t, o * f))       # recurrence
            selected, logits = select_sp(model.att_head, local, att_h)
            y = head_sp(model.box_head, model.video_lstm(selected))
            y, logits = (_gather(mesh, DATA_AXIS, a, 0) for a in (y, logits))
            return y, logits.transpose(1, 2)

    return forward
