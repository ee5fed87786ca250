"""Device-mesh parallelism over processes, one device each: the counterpart
of `objectpermanence_tpu/parallel/`. Data parallelism over the
batch-of-videos axis is the primary strategy: `mesh.py` builds the process
group's meshes, `data_parallel.py` runs a model under DDP over the data
dim, `fsdp.py` shards the model state over it. The model-parallel layers
beside it: `sharding.py` (tensor parallel over the `model` dim),
`sequence.py` (frames over `model`), `pipeline.py` (a GPipe schedule over
`pipe`) and `expert.py` (experts over `expert`); `dryrun.py` runs all of
them once, as `__graft_entry__.py::dryrun_multichip` does.
"""

from objectpermanence_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, MODEL_AXIS, batch_sharding, make_mesh, replicate, shard_batch,
)
