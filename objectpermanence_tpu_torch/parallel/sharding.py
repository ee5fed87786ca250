"""Tensor parallelism over a mesh's `model` dim, the counterpart of
`objectpermanence_tpu/parallel/sharding.py`.

The rule is JAX's (`tp_param_shardings`): an LSTM's `w_ih` and `w_hh` are
sharded over their 4H gate dim (dim 1), a 2-D `w` with more rows than
columns (a head that reads the hidden state) over its rows (dim 0), every
other leaf is replicated. A leaf whose sharded dim the `model` width does
not divide is replicated with a warning, or raises under `strict`. Shard k
of a dim of n ranks is its k-th contiguous part, as in JAX, so each rank
holds the numbers its JAX device holds. `shard_params` places the leaves as
DTensors on the (data, model) mesh, `[Replicate(), Shard(d)]`: the
counterpart of `NamedSharding`.

How a sharded model computes:
- An LSTM gathers its weights once per call (`full_tensor()`) and runs the
  whole recurrence: on the card K2/K3 in a train step and K4 without a
  gradient, which take a whole `w_hh (H, 4H)` resident (a recurrence split
  over the gate columns would need every rank's h at each step). The
  gather's backward keeps the rank's own part of the gradient.
- A row-sharded head multiplies the rank's rows of h by its rows of `w`
  and sums the parts over `model` (`sum_over_group`); the gradient of h is
  summed back over `model` (`copy_to_group`), so every rank of a `model`
  group carries the same, whole gradient into the layers below it, and the
  ranks' gradients of a gathered weight agree.
- The gradients are averaged over the `data` dim as each is accumulated
  (each data rank runs its slice of the batch), and Adam's moments, made
  like the parameters, stay sharded with them.

A sharded model's `forward_layers` is the step's entry
(`train/loop.py::make_train_step(spec, optimizer, mesh=mesh)`); `forward`,
OPNet's fused kernel (K1), takes whole weights and is not for it. Tensor
parallelism covers the LSTM and linear layers: the reasoning models other
than `transformer_lstm` and `opnet_moe`.
"""

import copy
import warnings
from typing import Dict, Mapping, Optional, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from objectpermanence_tpu_torch.ops.linear import Linear
from objectpermanence_tpu_torch.ops.lstm import LSTM, lstm_layer
from objectpermanence_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_group, axis_slice, axis_width,
)


def _leaf_dim(name: str, shape) -> Optional[int]:
    """The dim JAX's `_leaf_spec` shards over `model`, or None."""
    key = name.split(".")[-1]
    if len(shape) != 2:
        return None
    rows, cols = shape
    if key in ("w_ih", "w_hh"):
        return 1                          # the 4H gate dim
    if key == "w" and rows > cols:
        return 0                          # a head reading the sharded hidden
    return None


def _named_shapes(params) -> Dict[str, tuple]:
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {name: tuple(value.shape) for name, value in items}


def tp_param_shardings(params: Union[nn.Module, Mapping], mesh,
                       strict: bool = False) -> Dict[str, Optional[int]]:
    """Per leaf name of `params` (a module or a state_dict of tensors or
    arrays), the dim sharded over `model`, or None where the leaf is
    replicated. `mesh` is the (data, model) mesh or its model width. A leaf
    whose sharded dim the width does not divide is replicated with a
    warning; with `strict` it raises, so a config-size regression cannot
    silently turn tensor parallelism off."""
    width = mesh if isinstance(mesh, int) else axis_width(mesh, MODEL_AXIS)
    dims = {}
    for name, shape in _named_shapes(params).items():
        dim = _leaf_dim(name, shape)
        if dim is not None and shape[dim] % width:
            desc = (f"tp: {name} dim {dim} ({shape[dim]}) does not divide model axis "
                    f"({width})")
            if strict:
                raise ValueError(desc + "; refusing silent replication")
            warnings.warn(desc + "; replicating this leaf", stacklevel=2)
            dim = None
        dims[name] = dim
    return dims


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    """The sum over the group forward; the gradient passed through as it is
    (every rank's loss downstream is the same)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """`x`, whose gradient is the sum of the group's ranks' gradients: the
    input of a layer whose ranks each compute a part of its output."""
    return _CopyToGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's ranks' `x` (an all-reduce), differentiable for
    a loss that every rank of the group computes alike."""
    return _SumOverGroup.apply(x, group)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class _GatheredLSTM(nn.Module):
    """An LSTM whose sharded weights are gathered once per call and run
    whole (`ops/lstm.py::lstm_layer`: K2/K3 or K4 on the card)."""

    def __init__(self, w_ih: nn.Parameter, w_hh: nn.Parameter):
        super().__init__()
        self.w_ih, self.w_hh = w_ih, w_hh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lstm_layer(x, self.w_ih.full_tensor(), self.w_hh.full_tensor())


class _RowParallelLinear(nn.Module):
    """`x @ w (+ b)` with `w`'s rows sharded over `model`: the rank's rows of
    x times its rows of w, summed over `model`. With `w` replicated, the
    product of the whole."""

    def __init__(self, w: nn.Parameter, b: Optional[nn.Parameter], mesh):
        super().__init__()
        self.w, self.b = w, b
        self.group = axis_group(mesh, MODEL_AXIS)
        self.sharded = isinstance(w.placements[-1], Shard)
        if self.sharded:
            self.rows = axis_slice(mesh, MODEL_AXIS, w.shape[0], "rows")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.sharded:
            part = copy_to_group(x, self.group)[..., self.rows] @ self.w.to_local()
            y = sum_over_group(part, self.group)
        else:
            y = x @ self.w.to_local()
        return y if self.b is None else y + self.b.to_local()


def _average_over(group, width: int):
    """A post-accumulate hook: the parameter's gradient averaged over `group`."""
    def hook(param):
        with torch.no_grad():
            grad = _local(param.grad)
            dist.all_reduce(grad, group=group)
            grad /= width
    return hook


def shard_params(model: nn.Module, mesh, strict: bool = False) -> nn.Module:
    """A copy of `model` with its leaves placed on the (data, model) mesh by
    `tp_param_shardings` (DTensors holding this rank's shards, the same
    numbers as JAX's `shard_params` puts on its device) and its LSTM and
    linear layers computing as the module docstring says. Every rank calls
    it with the same weights."""
    dims = tp_param_shardings(model, mesh, strict=strict)
    model = copy.deepcopy(model)
    placed = {}
    for name, param in model.named_parameters():
        dim = dims[name]
        local = param.detach()
        if dim is not None:
            index = [slice(None)] * param.dim()
            index[dim] = axis_slice(mesh, MODEL_AXIS, param.shape[dim])
            local = local[tuple(index)]
        placements = [Replicate(), Replicate() if dim is None else Shard(dim)]
        placed[name] = nn.Parameter(DTensor.from_local(local.contiguous().clone(), mesh,
                                                       placements, run_check=False))
    for name, module in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(module, LSTM):
            swapped = _GatheredLSTM(placed[prefix + "w_ih"], placed[prefix + "w_hh"])
        elif isinstance(module, Linear):
            swapped = _RowParallelLinear(placed[prefix + "w"], placed.get(prefix + "b"), mesh)
        elif module._parameters:
            raise ValueError(f"tensor parallelism covers LSTM and linear layers; {name!r} is "
                             f"a {type(module).__name__}")
        else:
            continue
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent), attr, swapped)
    width = axis_width(mesh, DATA_AXIS)
    if width > 1:
        hook = _average_over(axis_group(mesh, DATA_AXIS), width)
        for param in model.parameters():
            param.register_post_accumulate_grad_hook(hook)
    return model


def local_shards(model: nn.Module) -> Dict[str, torch.Tensor]:
    """This rank's part of each parameter of a sharded model, by name."""
    return {name: _local(param).detach() for name, param in model.named_parameters()}


def full_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of a sharded model whole (gathered over the mesh), by
    name: the state_dict of the model before `shard_params`."""
    return {name: (param.full_tensor() if isinstance(param, DTensor) else param).detach()
            for name, param in model.named_parameters()}
