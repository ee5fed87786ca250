"""Pipeline parallelism, the counterpart of
`objectpermanence_tpu/parallel/pipeline.py`: a fill-drain GPipe engine over
a mesh's `pipe` dim that runs any list of stage functions, and OPNet
through it in 2 and 4 stages.

The schedule (`make_gpipe_forward`, `make_gpipe_train_step`): each rank's
slice of the batch (the `data` dim) is cut into microbatches; pipe rank r
runs stage r on them in order, receiving each microbatch's activation from
rank r-1 and sending its own to rank r+1 by point-to-point messages, so at
step t rank r works on microbatch t-r. The last rank's outputs are
broadcast over `pipe` (JAX's one-hot `psum`). The backward runs the
schedule in reverse: the last rank takes the loss's gradient, and each rank
sends the gradient of the activation it received back to the rank before
it. Each rank holds and updates only its own stage's weights, with its own
optimizer; their gradients are averaged over `data`.

A stage function is JAX's: `fn(local, transit_in, x_mb) -> activation`,
where `local` is the rank's stage parameters (`StageParams`: `local["lstm"]
["w_ih"]`), `transit_in (mb, T, transit_dim)` the previous stage's
activation (zeros for stage 0), and `x_mb` this microbatch of the input.
The activation's last dim may be anything up to `transit_dim`: the engine
zero-pads it for the message. Where JAX stacks every stage's weights into
one tree padded to the largest (`_union_stack`), a rank here holds its own
stage unpadded; `models/convert.py` maps JAX's padded tree to the stages
and back.

OPNet's stage functions run their LSTMs through `ops/lstm.py::lstm_layer`:
on the card K2/K3 in a train step (at the microbatch's batch), K4 in the
forward alone.
"""

from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from objectpermanence_tpu_torch import MAX_OBJECTS_IN_FRAME
from objectpermanence_tpu_torch.ops.lstm import lstm_layer
from objectpermanence_tpu_torch.parallel.data_parallel import average_gradients
from objectpermanence_tpu_torch.parallel.mesh import (
    DATA_AXIS, PIPE_AXIS, axis_group, axis_rank, axis_width, batch_sharding,
)
from objectpermanence_tpu_torch.train.losses import total_loss

_FEAT = 6
_OBJECTS = MAX_OBJECTS_IN_FRAME


# ---------------------------------------------------------------------------
# stage parameters


def _union_stack(per_stage: Sequence):
    """JAX's stacked layout of a list of per-stage nested dicts of arrays
    (None where a stage lacks the subtree): key paths unioned, every leaf
    zero-padded to the largest shape of its path, stacked on a leading stage
    axis; numpy arrays."""
    dicts = [t for t in per_stage if t is not None]
    if all(isinstance(t, Mapping) for t in dicts):
        keys = sorted(set().union(*[t.keys() for t in dicts]))
        return {k: _union_stack([t.get(k) if t is not None else None for t in per_stage])
                for k in keys}
    if any(isinstance(t, Mapping) for t in dicts):
        raise ValueError("stage param trees disagree on dict-vs-leaf")
    arrs = [np.asarray(t.detach().cpu() if torch.is_tensor(t) else t) for t in dicts]
    if any(a.ndim != arrs[0].ndim for a in arrs):
        raise ValueError("stage param leaves disagree on rank")
    shape = tuple(max(a.shape[i] for a in arrs) for i in range(arrs[0].ndim))
    rows = []
    for t in per_stage:
        row = np.zeros(shape, arrs[0].dtype)
        if t is not None:
            a = np.asarray(t.detach().cpu() if torch.is_tensor(t) else t)
            row[tuple(slice(0, n) for n in a.shape)] = a
        rows.append(row)
    return np.stack(rows)


class StageParams(nn.Module):
    """One stage's nested dict of tensors as a module: sub-dicts are
    submodules, leaves parameters, read as in the JAX tree
    (`local["lstm"]["w_ih"]`); its state_dict keys join the path with dots."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(key, StageParams(value))
            else:
                self.register_parameter(key, nn.Parameter(torch.as_tensor(value).detach().clone()))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def stack_stage_param_list(stage_params: Sequence[Mapping], mesh) -> StageParams:
    """This pipe rank's stage of a list of per-stage parameter trees (one
    per pipe rank), unpadded: a rank holds only its own stage's weights."""
    if len(stage_params) != axis_width(mesh, PIPE_AXIS):
        raise ValueError(f"mesh pipe axis is {axis_width(mesh, PIPE_AXIS)} but "
                         f"{len(stage_params)} stage param trees were given")
    return StageParams(stage_params[axis_rank(mesh, PIPE_AXIS)])


# ---------------------------------------------------------------------------
# the generic N-stage GPipe schedule

StageFn = Callable


class _Pipe:
    """This rank's place in its pipe: its stage, its neighbours' global
    ranks and the microbatching of its data rows."""

    def __init__(self, mesh, n_stages: int, num_microbatches: int, transit_dim: int,
                 out_dim: int):
        width = axis_width(mesh, PIPE_AXIS)
        if width != n_stages:
            raise ValueError(f"mesh pipe axis is {width} but {n_stages} stage functions were "
                             f"given")
        self.mesh, self.m = mesh, num_microbatches
        self.transit_dim, self.out_dim = transit_dim, out_dim
        self.group = axis_group(mesh, PIPE_AXIS)
        self.rank = axis_rank(mesh, PIPE_AXIS)
        self.last = self.rank == n_stages - 1

        def peer(r):
            return dist.get_global_rank(self.group, r)
        self.prev = peer(self.rank - 1) if self.rank > 0 else None
        self.next = peer(self.rank + 1) if not self.last else None
        self.last_global = peer(n_stages - 1)

    def microbatches(self, x: torch.Tensor) -> torch.Tensor:
        rows = x[batch_sharding(self.mesh, x.shape[0])]
        if rows.shape[0] % self.m:
            raise ValueError(f"{rows.shape[0]} rows per data rank do not split into "
                             f"{self.m} microbatches")
        return rows.reshape((self.m, rows.shape[0] // self.m) + rows.shape[1:])

    def run(self, fn: StageFn, local, mbs: torch.Tensor, train: bool):
        """The forward schedule: -> [(activation received, activation sent
        or kept)] per microbatch."""
        steps, sends = [], []
        shape = mbs.shape[1:3] + (self.transit_dim,)
        for x_mb in mbs:
            transit = torch.zeros(shape, dtype=mbs.dtype, device=mbs.device)
            if self.prev is not None:
                dist.recv(transit, src=self.prev)
                transit.requires_grad_(train)
            act = fn(local, transit, x_mb)
            act = F.pad(act, (0, self.transit_dim - act.shape[-1]))
            if self.next is not None:
                sends.append(dist.isend(act.detach().contiguous(), dst=self.next))
            steps.append((transit, act))
        for work in sends:
            work.wait()
        return steps

    def outputs(self, steps) -> torch.Tensor:
        """The last rank's outputs of this rank's data rows, `(B/d, T, out)`."""
        return torch.cat([act[..., :self.out_dim] for _, act in steps])

    def broadcast(self, tensor: torch.Tensor) -> torch.Tensor:
        dist.broadcast(tensor, src=self.last_global, group=self.group)
        return tensor

    def gather_data(self, rows: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(rows) for _ in range(axis_width(self.mesh, DATA_AXIS))]
        dist.all_gather(parts, rows.contiguous(), group=axis_group(self.mesh, DATA_AXIS))
        return torch.cat(parts)


def make_gpipe_forward(mesh, stage_fns: Sequence[StageFn], *, transit_dim: int, out_dim: int,
                       num_microbatches: int = 4):
    """-> `fn(local, x (B, T, ...))` -> `(B, T, out_dim)` on every rank.
    `local` is this rank's stage (`stack_stage_param_list`); the pipe width
    must equal `len(stage_fns)`, and B must divide into data width x
    `num_microbatches`. Records no gradient."""
    pipe = _Pipe(mesh, len(stage_fns), num_microbatches, transit_dim, out_dim)
    fn = stage_fns[pipe.rank]

    @torch.no_grad()
    def forward(local, x):
        mbs = pipe.microbatches(x)
        steps = pipe.run(fn, local, mbs, train=False)
        if pipe.last:
            y = pipe.outputs(steps)
        else:
            y = mbs.new_empty((mbs.shape[0] * mbs.shape[1], mbs.shape[2], out_dim))
        return pipe.gather_data(pipe.broadcast(y))

    return forward


def make_gpipe_train_step(mesh, stage_fns: Sequence[StageFn], optimizer, *, transit_dim: int,
                          out_dim: int, num_microbatches: int = 4, loss_fn=None):
    """A train step through the GPipe schedule: the reference loss (L1 and
    temporal consistency, or `loss_fn(y, labels, mask) -> (loss, metrics)`)
    of each data rank's rows on the last pipe rank, the backward through the
    schedule in reverse, the gradients averaged over `data`, and
    `optimizer` (over this rank's stage) stepped.

    -> `step(local, x, labels, mask)` -> metrics of the global batch (0-d
    tensors, the same on every rank); updates `local` in place, and leaves
    its gradients in `.grad`."""
    if loss_fn is None:
        def loss_fn(y, labels, mask):
            return total_loss(y, labels, mask, False)
    pipe = _Pipe(mesh, len(stage_fns), num_microbatches, transit_dim, out_dim)
    fn = stage_fns[pipe.rank]
    data_group = axis_group(mesh, DATA_AXIS)
    data_width = axis_width(mesh, DATA_AXIS)

    def step(local, x, labels, mask):
        optimizer.zero_grad(set_to_none=True)
        mbs = pipe.microbatches(x)
        steps = pipe.run(fn, local, mbs, train=True)
        rows = batch_sharding(mesh, x.shape[0])
        if pipe.last:
            y = pipe.outputs(steps)
            pipe.broadcast(y.detach().clone())
        else:   # every rank computes the metrics from the last rank's outputs
            y = pipe.broadcast(mbs.new_empty((x.shape[0] // data_width, x.shape[1], out_dim)))
        loss, metrics = loss_fn(y, labels[rows], mask[rows])
        sends = []
        if pipe.last:
            loss.backward()
        for transit, act in reversed(steps):
            if not pipe.last:
                grad = torch.empty_like(act)
                dist.recv(grad, src=pipe.next)
                act.backward(grad)
            if pipe.prev is not None:
                sends.append(dist.isend(transit.grad.contiguous(), dst=pipe.prev))
        for work in sends:
            work.wait()
        average_gradients(list(local.parameters()), data_group)
        optimizer.step()
        values = torch.stack([v.detach() for v in metrics.values()])
        dist.all_reduce(values, group=data_group)
        return dict(zip(metrics, values / data_width))

    return step


# ---------------------------------------------------------------------------
# OPNet expressed through the engine (2- and 4-stage splits)


def _linear(head, x):
    y = x @ head["w"]
    return y + head["b"] if "b" in head else y


def opnet_pipeline_stages(config: Mapping[str, int], num_stages: int = 2):
    """-> (stage_fns, transit_dim). 2 stages: (A) the who-to-attend LSTM,
    head and selection, (B) the video LSTM and box head, the reference's
    factoring; 4 stages: att LSTM / selection / video LSTM / box head, a
    longer ring with the same math. Parameters: `stack_stage_params`."""
    att_hidden = config["object_to_track_hidden_dim"]
    vid_hidden = config["videos_hidden_dim"]

    def att_lstm(local, transit, x_mb):
        scene = x_mb.reshape(x_mb.shape[:2] + (_OBJECTS * _FEAT,))
        return lstm_layer(scene, local["lstm"]["w_ih"], local["lstm"]["w_hh"])

    def select(local, transit, x_mb):
        probs = torch.softmax(_linear(local["head"], transit[..., :att_hidden]), dim=-1)
        return torch.einsum("btof,bto->btf", x_mb, probs)            # (mb, T, 6)

    def video_lstm(local, transit, x_mb):
        return lstm_layer(transit[..., :_FEAT], local["lstm"]["w_ih"], local["lstm"]["w_hh"])

    def box_head(local, transit, x_mb):
        return _linear(local["head"], transit[..., :vid_hidden])     # (mb, T, 4)

    def stage_a(local, transit, x_mb):
        return select(local, att_lstm(local, transit, x_mb), x_mb)

    def stage_b(local, transit, x_mb):
        return box_head(local, video_lstm(local, transit, x_mb), x_mb)

    if num_stages == 2:
        return [stage_a, stage_b], max(_FEAT, 4)
    if num_stages == 4:
        return [att_lstm, select, video_lstm, box_head], max(att_hidden, vid_hidden, _FEAT, 4)
    raise ValueError(f"unsupported OPNet split: {num_stages} stages")


def opnet_stage_trees(state: Mapping, num_stages: int = 2) -> List[Dict]:
    """OPNet's flat parameters (`att_lstm.w_ih`, ... -> tensor, array or
    shape) -> the per-stage trees of the chosen split."""
    def lstm(prefix):
        return {"w_ih": state[f"{prefix}.w_ih"], "w_hh": state[f"{prefix}.w_hh"]}

    def head(prefix):
        return {"w": state[f"{prefix}.w"]}

    if num_stages == 2:
        return [{"lstm": lstm("att_lstm"), "head": head("att_head")},
                {"lstm": lstm("video_lstm"), "head": head("box_head")}]
    if num_stages == 4:
        return [{"lstm": lstm("att_lstm")}, {"head": head("att_head")},
                {"lstm": lstm("video_lstm")}, {"head": head("box_head")}]
    raise ValueError(f"unsupported OPNet split: {num_stages} stages")


def opnet_stage_shapes(config: Mapping[str, int], num_stages: int = 2) -> List[Dict]:
    """The per-stage trees of leaf shapes of an OPNet of `config`, which
    unpad JAX's stacked tree (`_unpad_lstm`, `_unpad_head`)."""
    att, vid = config["object_to_track_hidden_dim"], config["videos_hidden_dim"]
    shapes = {"att_lstm.w_ih": (_OBJECTS * _FEAT, 4 * att), "att_lstm.w_hh": (att, 4 * att),
              "att_head.w": (att, config["object_to_track_pred_dim"]),
              "video_lstm.w_ih": (_FEAT, 4 * vid), "video_lstm.w_hh": (vid, 4 * vid),
              "box_head.w": (vid, 4)}
    return opnet_stage_trees(shapes, num_stages)


def stack_stage_params(model: nn.Module, mesh, num_stages: int = 2) -> StageParams:
    """This pipe rank's stage of an OPNet (its parameters' copies, on their
    device) for the chosen split."""
    return stack_stage_param_list(opnet_stage_trees(dict(model.named_parameters()), num_stages),
                                  mesh)


def make_pipelined_opnet_forward(mesh, config: Mapping[str, int], num_microbatches: int = 4,
                                 num_stages: int = 2):
    """-> `fn(local, boxes (B, T, 15, 6))` -> `(B, T, 4)` boxes, OPNet's
    box output (the who-to-attend logits stay inside). `local` from
    `stack_stage_params` with the same `num_stages`."""
    stage_fns, transit = opnet_pipeline_stages(config, num_stages)
    return make_gpipe_forward(mesh, stage_fns, transit_dim=transit, out_dim=4,
                              num_microbatches=num_microbatches)


def make_pipelined_opnet_train_step(mesh, config: Mapping[str, int], optimizer,
                                    num_microbatches: int = 4, num_stages: int = 2):
    """A train step of OPNet through the N-stage schedule; `optimizer` is
    over this rank's stage (`stack_stage_params`)."""
    stage_fns, transit = opnet_pipeline_stages(config, num_stages)
    return make_gpipe_train_step(mesh, stage_fns, optimizer, transit_dim=transit, out_dim=4,
                                 num_microbatches=num_microbatches)
