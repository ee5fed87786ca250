"""Process groups and meshes, the counterpart of
`objectpermanence_tpu/parallel/mesh.py`.

The workload is many independent 300-frame videos, so the batch axis is the
scaling axis: each process (rank) of the `DATA_AXIS` dim of a mesh runs its
contiguous slice of every global batch, and the gradients are averaged over
the dim. JAX's devices are the port's ranks, one card each: a
`torch.distributed.device_mesh.DeviceMesh` over the initialized process
group takes the place of `jax.sharding.Mesh`, and `P(DATA_AXIS)` becomes
"this rank's slice of the batch axis" (`batch_sharding`, `shard_batch`).

Without a launcher there is no process group, and the entry points run on one
device with no mesh, as before. Under `torchrun`, `init_from_env` starts the
group from its `RANK`, `WORLD_SIZE` and `LOCAL_RANK`: NCCL with one card per
rank (`cuda:LOCAL_RANK`), or gloo for ranks on the CPU.
"""

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"


def init_from_env(device) -> torch.device:
    """Start the default process group from `torchrun`'s environment and
    return this rank's device: `cuda:LOCAL_RANK` over NCCL where `device` is
    the card, the CPU over gloo where it is the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                **({"device_id": device} if device.type == "cuda" else {}))
    return device


def mesh_from_env(device):
    """(mesh, device) of this process: under a launcher, the data mesh over
    every rank and this rank's device (`init_from_env`); without one, (None,
    `device`). A launcher is told by `WORLD_SIZE`, which `torchrun` sets."""
    if "WORLD_SIZE" not in os.environ:
        return None, device
    device = init_from_env(device)
    return make_mesh(), device


def _make(n_data: Optional[int], n_other: int, names) -> DeviceMesh:
    if not dist.is_initialized():
        raise ValueError(
            "a mesh needs the process group: start one process per device with "
            "`torchrun --nproc_per_node N ...`, or call torch.distributed.init_process_group "
            "first (without a launcher the entry points take no mesh)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_other
    used = n_data * n_other
    if world < used:
        raise ValueError(
            f"the mesh needs {used} processes ({names[0]}={n_data} x {names[1]}={n_other}) "
            f"but the process group has {world}. Start one process per device with "
            f"`torchrun --nproc_per_node {used} ...`.")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(used).reshape(n_data, n_other),
                      mesh_dim_names=names)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over the first `n_data * n_model` ranks of the
    process group (all of them by default)."""
    return _make(n_data, n_model, (DATA_AXIS, MODEL_AXIS))


def make_pipe_mesh(n_data: Optional[int] = None, n_pipe: int = 2) -> DeviceMesh:
    """A (data, pipe) mesh for pipeline parallelism."""
    return _make(n_data, n_pipe, (DATA_AXIS, PIPE_AXIS))


def make_expert_mesh(n_data: Optional[int] = None, n_expert: int = 2) -> DeviceMesh:
    """A (data, expert) mesh for expert parallelism."""
    return _make(n_data, n_expert, (DATA_AXIS, EXPERT_AXIS))


def axis_width(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along the mesh dim `axis` (`data`, `model`,
    `pipe` or `expert`)."""
    return mesh[axis].size()


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along the mesh dim `axis`."""
    return mesh[axis].get_group()


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along the mesh dim `axis`."""
    return mesh[axis].get_local_rank()


def data_width(mesh: DeviceMesh) -> int:
    return axis_width(mesh, DATA_AXIS)


def data_group(mesh: DeviceMesh):
    return axis_group(mesh, DATA_AXIS)


def replicate(mesh: DeviceMesh) -> list:
    """The placements of a tensor held whole by every rank of `mesh`
    (`P()` in JAX)."""
    return [Replicate()] * mesh.ndim


def axis_slice(mesh: DeviceMesh, axis: str, size: int, what: str = "dim") -> slice:
    """This rank's contiguous slice of a dim of `size` split over the mesh
    dim `axis`, which must divide it (what `P(axis)` gives each JAX
    device)."""
    width = axis_width(mesh, axis)
    if size % width:
        raise ValueError(f"{what} {size} does not divide over {width} {axis} ranks")
    per = size // width
    start = axis_rank(mesh, axis) * per
    return slice(start, start + per)


def batch_sharding(mesh: DeviceMesh, batch_size: int) -> slice:
    """This rank's contiguous slice of a batch axis of `batch_size`, which
    the data width divides (what `P(DATA_AXIS)` gives each JAX device)."""
    return axis_slice(mesh, DATA_AXIS, batch_size, "batch")


def shard_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """This rank's slice of every array member of a batch dict (the batch
    size divides the data axis: callers pad the final batch); other members
    are kept as they are."""
    arrays = [v for v in batch.values() if hasattr(v, "shape")]
    rows = batch_sharding(mesh, arrays[0].shape[0])
    return {key: value[rows] if hasattr(value, "shape") else value
            for key, value in batch.items()}


def pad_batch_to(batch: dict, size: int) -> tuple:
    """Pad all array members of `batch` along axis 0 up to `size` by
    repeating the last element; returns (padded_batch, real_count)."""
    arrays = {k: v for k, v in batch.items() if hasattr(v, "shape")}
    count = next(iter(arrays.values())).shape[0]
    if count == size:
        return batch, count
    out = dict(batch)
    for key, value in arrays.items():
        pad = np.repeat(value[-1:], size - count, axis=0)
        out[key] = np.concatenate([value, pad], axis=0)
    return out, count
