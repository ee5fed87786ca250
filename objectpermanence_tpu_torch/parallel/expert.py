"""Expert parallelism, the counterpart of the sharded layers of
`objectpermanence_tpu/parallel/expert.py`: a Switch-style top-1
mixture-of-experts layer whose experts are sharded over a mesh's `expert`
dim. The dense single-device head (`MoEHead`, `moe_route`,
`moe_balance_loss`) is `models/moe.py`'s and is reused here.

Layout: every expert weight has a leading `num_experts` axis, split over
`expert` (each rank stores and computes only its E/n experts); the router is
replicated. Tokens stay split over `data` by their batch rows, so a layer
takes and returns this rank's rows, as a layer of a data-parallel model.
Dispatch is dense and masked: each rank runs its local experts on all its
tokens, zeroes the tokens routed elsewhere (top-1 minus its first expert
outside `[0, E/n)`), and an all-reduce over `expert` sums the ranks' parts
(`sharding.sum_over_group`). The layer's input and the router pass through
`sharding.copy_to_group`, so their gradients are summed over `expert` and
every rank of an `expert` group holds the whole gradient of the router and
of the tokens. The gradients are not averaged over `data` here: that is
the caller's, as for any data-parallel parameter.

Expert parallelism runs no Pallas kernel in JAX and none here.
"""

from typing import Any, Dict

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from objectpermanence_tpu_torch.models.moe import MoEHead, moe_route
from objectpermanence_tpu_torch.parallel.mesh import (
    EXPERT_AXIS, axis_group, axis_rank, axis_slice, replicate,
)
from objectpermanence_tpu_torch.parallel.sharding import copy_to_group, sum_over_group


def expert_param_shardings() -> Dict[str, Any]:
    """Per leaf of a `MoEHead`, the dim split over `expert` (the experts'
    leading axis), or None for the replicated router."""
    return {"router": None, "w1": 0, "w2": 0}


def shard_expert_params(head: MoEHead, mesh) -> nn.ParameterDict:
    """A `MoEHead`'s leaves on the (data, expert) mesh, as DTensors: the
    rank's experts `[Replicate(), Shard(0)]`, the router whole. Every rank
    calls it with the same weights."""
    out = nn.ParameterDict()
    for name, dim in expert_param_shardings().items():
        value = getattr(head, name).detach()
        placements = replicate(mesh)
        if dim is not None:
            value = value[axis_slice(mesh, EXPERT_AXIS, value.shape[0], "experts")]
            placements = [placements[0], Shard(dim)]
        out[name] = nn.Parameter(DTensor.from_local(value.contiguous().clone(), mesh,
                                                    placements, run_check=False))
    return out


def _expert_mlp(w1, w2, h):
    """`h (..., in)` through one expert's MLP -> `(..., out)`."""
    return torch.relu(h @ w1) @ w2


def make_expert_parallel_layer(mesh, expert_fn):
    """A top-1 expert-parallel layer over any expert computation.

    `expert_fn(expert_params, h) -> (..., out)` evaluates one expert from
    its slice of the parameters (leaves without the experts' axis). The
    layer is `layer(params, h)` with `params = {"router": (in, E),
    "experts": {name: (E/n, ...)}}`, the rank's experts and the whole
    router as tensors, and `h (B/d, ..., in)` this rank's rows; it returns
    `(B/d, ..., out)`."""
    group = axis_group(mesh, EXPERT_AXIS)

    def ep_layer(params, h):
        experts = params["experts"]
        local_e = next(iter(experts.values())).shape[0]
        first = axis_rank(mesh, EXPERT_AXIS) * local_e
        h = copy_to_group(h, group)
        top1, gate, _ = moe_route(copy_to_group(params["router"], group), h)
        outs = torch.stack([expert_fn({k: v[e] for k, v in experts.items()}, h)
                            for e in range(local_e)])                 # (E/n, ..., out)
        # top1 - first outside [0, E/n): another rank's expert, a zero row
        mine = torch.arange(first, first + local_e, device=h.device)
        onehot = (top1.unsqueeze(-1) == mine).to(h.dtype)
        combined = torch.einsum("e...o,...e->...o", outs, onehot) * gate.unsqueeze(-1)
        return sum_over_group(combined, group)

    return ep_layer


def make_expert_parallel_moe_head(mesh):
    """-> `fn(sharded, h (B/d, ..., in))` -> `(B/d, ..., out)`, the
    function of `MoEHead.forward` with each rank computing only its local
    experts; `sharded` from `shard_expert_params`. An instance of
    `make_expert_parallel_layer` with the house two-layer MLP expert."""
    layer = make_expert_parallel_layer(mesh, lambda ep, h: _expert_mlp(ep["w1"], ep["w2"], h))

    def ep_head(sharded, h):
        return layer({"router": sharded["router"].to_local(),
                      "experts": {"w1": sharded["w1"].to_local(),
                                  "w2": sharded["w2"].to_local()}}, h)

    return ep_head
