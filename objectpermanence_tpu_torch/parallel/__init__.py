"""Data parallelism over processes, one device each: the counterpart of
`objectpermanence_tpu/parallel/` (its mesh, the data-parallel training and
FSDP). Data parallelism over the batch-of-videos axis is the primary
strategy: `mesh.py` builds the process group's mesh, `data_parallel.py` runs
a model under DDP over its data dim, `fsdp.py` shards the model state over
it. The model-parallel layers (tensor, sequence, pipeline and expert
parallel) are not ported yet.
"""

from objectpermanence_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, batch_sharding, make_mesh, shard_batch,
)
