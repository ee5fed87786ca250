"""Fully sharded data parallelism for the reasoning models, the counterpart
of `objectpermanence_tpu/parallel/fsdp.py`, with torch's FSDP2
(`torch.distributed.fsdp.fully_shard`).

Each large parameter is sharded over the mesh's data dim along its largest
dim that the data width divides, and so are Adam's moments, which torch
keeps beside each (sharded) parameter: per-rank memory for the model state
drops by about the data width. FSDP2 all-gathers a parameter before the
forward and backward and reduce-scatters its gradient (the mean over the
ranks) before the sharded Adam update, the pattern XLA derives in JAX.

JAX's rule keeps leaves under `min_size` elements, or with no dim the width
divides, replicated. FSDP2 shards every parameter of the module it is
applied to, so the port keeps such leaves out of it (`ignored_params`): they
stay whole on every rank, and the step averages their gradients over the
dim itself (`data_parallel.average_gradients`), which is what replication
means for them in JAX.
"""

from typing import Dict, Optional

import torch
from torch import nn
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Shard

from objectpermanence_tpu_torch.parallel.data_parallel import (
    Entry, average_gradients, layers_entry,
)
from objectpermanence_tpu_torch.parallel.mesh import DATA_AXIS
from objectpermanence_tpu_torch.train.losses import total_loss


def fsdp_param_shardings(model: nn.Module, mesh, axis: str = DATA_AXIS,
                         min_size: int = 2 ** 12) -> Dict[str, Optional[int]]:
    """Per parameter name, the dim sharded over `axis` (the largest the
    axis size divides), or None where the parameter stays replicated: fewer
    than `min_size` elements, or no dim divisible."""
    n = mesh[axis].size()
    shardings = {}
    for name, param in model.named_parameters():
        shardings[name] = None
        if param.dim() == 0 or param.numel() < min_size:
            continue
        for d in sorted(range(param.dim()), key=lambda d: param.shape[d], reverse=True):
            if param.shape[d] % n == 0:
                shardings[name] = d
                break
    return shardings


def shard_model(model: nn.Module, mesh, axis: str = DATA_AXIS,
                min_size: int = 2 ** 12) -> nn.Module:
    """`model` under FSDP2 over `axis`, by `fsdp_param_shardings`; returns
    the sharded module, whose call is the model's `forward_layers`. The
    model's sharded parameters become DTensors holding this rank's shard;
    the replicated ones stay tensors."""
    shardings = fsdp_param_shardings(model, mesh, axis, min_size)
    params = dict(model.named_parameters())
    dims = {params[name]: dim for name, dim in shardings.items()}
    root = Entry(model, layers_entry)
    fully_shard(root, mesh=mesh[axis], shard_placement_fn=lambda p: Shard(dims[p]),
                ignored_params={params[name] for name, dim in shardings.items() if dim is None})
    return root


def replicated_params(sharded: nn.Module):
    return [p for p in sharded.parameters() if not isinstance(p, DTensor)]


def param_groups(sharded: nn.Module):
    """The sharded module's parameters for an optimizer, in two groups, the
    DTensors and the replicated tensors: a multi-tensor (foreach) update,
    torch's default on the card, cannot mix the two."""
    replicated = replicated_params(sharded)
    return [{"params": [p for p in sharded.parameters() if isinstance(p, DTensor)]},
            {"params": replicated}]


def make_fsdp_train_step(spec, optimizer: torch.optim.Optimizer, mesh, axis: str = DATA_AXIS):
    """`step(sharded, boxes, labels, mask)` -> metrics: one train step of
    the module `shard_model` returned, on this rank's slice of the batch.
    The loss is the unweighted mean of JAX's FSDP step; the ranks' slices
    are equal, so the mean of their gradients is the global batch's, and
    the numerics are the single-device step's, with sums in another order.
    `optimizer` is over `param_groups(sharded)`."""
    group = mesh[axis].get_group()
    width = mesh[axis].size()

    def step(sharded, boxes, labels, mask):
        optimizer.zero_grad(set_to_none=True)
        out = sharded(boxes)
        if spec.double_output:
            out = out[0]
        loss, metrics = total_loss(out, labels, mask, spec.no_labels)
        loss.backward()
        average_gradients(replicated_params(sharded), group)
        optimizer.step()
        values = torch.stack([v.detach() for v in metrics.values()])
        torch.distributed.all_reduce(values, group=group)
        return dict(zip(metrics, values / width))

    return step
