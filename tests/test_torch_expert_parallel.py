"""The port's expert parallelism (`parallel/expert.py`) against the JAX
package's (`objectpermanence_tpu/parallel/expert.py`), at world 4 over gloo,
(data 2, expert 2), against JAX's `make_expert_parallel_moe_head` and
`make_expert_parallel_layer` on a (2, 2) mesh of the conftest's virtual CPU
devices, same weights (`moe_head_init` through `shard_from_jax`) and
inputs, at JAX's limits (rtol 2e-5, atol 2e-6):
- the MoE head's forward on each rank's rows;
- the gradients of mean(y^2) for the router (whole on every rank) and for
  `w1`, `w2` (each rank its two experts), averaged over data;
- a layer with a gated three-matrix expert (`test_ep_generic_layer_custom_expert`);
- each rank holds only E/2 experts of each expert leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from objectpermanence_tpu.parallel.expert import (
    EXPERT_AXIS, make_expert_parallel_layer as jax_ep_layer,
    make_expert_parallel_moe_head as jax_ep_head, moe_head_init,
    shard_expert_params as jax_shard_expert_params,
)
from objectpermanence_tpu.parallel.mesh import make_expert_mesh as jax_make_expert_mesh
from objectpermanence_tpu_torch.models.convert import shard_from_jax
from objectpermanence_tpu_torch.parallel.expert import expert_param_shardings
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_dp_workers import (
    MOE_EXPERTS, MOE_HIDDEN, MOE_IN, MOE_OUT, ep_suite, start,
)
from torch_lane import one_torch_thread  # noqa: F401

LIMITS = dict(rtol=2e-5, atol=2e-6)
BATCH, FRAMES = 8, 10


def _gated(ep, x):
    return (jax.nn.sigmoid(x @ ep["wg"]) * (x @ ep["wu"])) @ ep["wo"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ep")
    head = jax.device_get(moe_head_init(jax.random.PRNGKey(5), MOE_IN, MOE_OUT,
                                        num_experts=MOE_EXPERTS, expert_hidden=MOE_HIDDEN))
    save_params(out / "ep_head.npz", shard_from_jax(head, expert_param_shardings(), 1, 0))
    rng = np.random.RandomState(7)
    hid = 12
    inputs = {"h": rng.randn(BATCH, FRAMES, MOE_IN).astype(np.float32),
              "router": (rng.randn(MOE_IN, MOE_EXPERTS) * 0.2).astype(np.float32),
              "wg": (rng.randn(MOE_EXPERTS, MOE_IN, hid) * 0.2).astype(np.float32),
              "wu": (rng.randn(MOE_EXPERTS, MOE_IN, hid) * 0.2).astype(np.float32),
              "wo": (rng.randn(MOE_EXPERTS, hid, 5) * 0.2).astype(np.float32),
              "gh": rng.randn(BATCH, FRAMES, MOE_IN).astype(np.float32)}
    np.savez(out / "ep_inputs.npz", **inputs)
    wait = start(ep_suite, 4, out, str(out))
    try:
        mesh = jax_make_expert_mesh(n_data=2, n_expert=2)
        sharded = jax_shard_expert_params(head, mesh)
        ep_head = jax_ep_head(mesh)
        h = jnp.asarray(inputs["h"])
        want = {"y": np.asarray(ep_head(sharded, h))}
        grads = jax.grad(lambda p: jnp.mean(ep_head(p, h) ** 2))(sharded)
        want.update({f"grad/{k}": np.asarray(v) for k, v in grads.items()})
        from jax.sharding import NamedSharding, PartitionSpec as P
        custom = {"router": jax.device_put(jnp.asarray(inputs["router"]),
                                           NamedSharding(mesh, P())),
                  "experts": {k: jax.device_put(jnp.asarray(inputs[k]),
                                                NamedSharding(mesh, P(EXPERT_AXIS)))
                              for k in ("wg", "wu", "wo")}}
        want["custom_y"] = np.asarray(jax_ep_layer(mesh, _gated)(custom,
                                                                 jnp.asarray(inputs["gh"])))
    finally:
        wait()
    ranks = []
    for rank in range(4):
        with np.load(out / f"ep_rank{rank}.npz") as blob:
            ranks.append({k: blob[k] for k in blob.files})
    return ranks, want


def _rows(rank):
    data = rank // 2
    return slice(data * BATCH // 2, (data + 1) * BATCH // 2)


def _experts(rank):
    expert = rank % 2
    return slice(expert * MOE_EXPERTS // 2, (expert + 1) * MOE_EXPERTS // 2)


@pytest.mark.parametrize("rank", range(4))
def test_ep_head_forward_matches_jax(runs, rank):
    got, want = runs[0][rank], runs[1]
    np.testing.assert_allclose(got["y"], want["y"][_rows(rank)], **LIMITS)


@pytest.mark.parametrize("rank", range(4))
def test_ep_head_grads_match_jax(runs, rank):
    got, want = runs[0][rank], runs[1]
    np.testing.assert_allclose(got["grad/router"], want["grad/router"], **LIMITS)
    for name in ("w1", "w2"):
        np.testing.assert_allclose(got[f"grad/{name}"], want[f"grad/{name}"][_experts(rank)],
                                   **LIMITS, err_msg=name)


@pytest.mark.parametrize("rank", range(4))
def test_ep_generic_layer_custom_expert_matches_jax(runs, rank):
    got, want = runs[0][rank], runs[1]
    np.testing.assert_allclose(got["custom_y"], want["custom_y"][_rows(rank)], **LIMITS)


@pytest.mark.parametrize("rank", range(4))
def test_ep_each_rank_holds_half_the_experts(runs, rank):
    got = runs[0][rank]
    assert tuple(got["held/w1"]) == (MOE_EXPERTS // 2, MOE_IN, MOE_HIDDEN)
    assert tuple(got["held/w2"]) == (MOE_EXPERTS // 2, MOE_HIDDEN, MOE_OUT)
    assert tuple(got["held/router"]) == (MOE_IN, MOE_EXPERTS)
