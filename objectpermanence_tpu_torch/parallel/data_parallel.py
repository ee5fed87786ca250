"""Data parallelism over a mesh's data dim with `DistributedDataParallel`.

Where JAX shards each batch over `DATA_AXIS` and XLA inserts the gradient
all-reduce, each rank here runs its slice of the batch and DDP averages the
parameters' gradients over the dim, bucketed and overlapped with the
backward. DDP prepares its gradient hooks in `forward`, so a train step
must enter the model through the wrapper: `DataParallel` runs
`entry(module, ...)` as its forward (the reasoning models' `forward_layers`,
the detector's loss). Tensors the optimizer updates that are not parameters
(frozen batch norm's buffers, which JAX trains as leaves of its tree) get no
hook from DDP; `average_gradients` averages theirs.
"""

from typing import Callable, List

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from objectpermanence_tpu_torch.parallel.mesh import data_group


class Entry(nn.Module):
    """`entry(module, ...)` as a module's forward."""

    def __init__(self, module: nn.Module, entry: Callable):
        super().__init__()
        self.module = module
        self.entry = entry

    def forward(self, *args, **kwargs):
        return self.entry(self.module, *args, **kwargs)


class DataParallel(DistributedDataParallel):
    """`entry(module, *args, **kwargs)` under DDP over the data dim of
    `mesh`; calling the wrapper runs it. `forward_layers` calls it too, so a
    reasoning model's train step takes the wrapper in the model's place."""

    def __init__(self, module: nn.Module, mesh, entry: Callable):
        device = next(module.parameters()).device
        super().__init__(Entry(module, entry),
                         device_ids=[device.index] if device.type == "cuda" else None,
                         process_group=data_group(mesh), broadcast_buffers=False)
        self.mesh = mesh

    def forward_layers(self, *args, **kwargs):
        return self(*args, **kwargs)


def layers_entry(model, *args, **kwargs):
    """A reasoning model's layer-by-layer function (`forward` is K1's)."""
    return model.forward_layers(*args, **kwargs)


def average_gradients(tensors: List[torch.Tensor], group) -> None:
    """Average the gradients of `tensors` over the ranks of `group`, in one
    collective."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.view_as(g))
