"""The port's pipeline parallelism (`parallel/pipeline.py`) against the JAX
package's (`objectpermanence_tpu/parallel/pipeline.py`).

Without a spawn: the weight converter's round trip against JAX's union
layout (`stack_stage_param_list`, zero-padded, stage-stacked) for both
OPNet splits and an uneven pair of trees, and the raise on a pipe width
that differs from the number of stages (in a one-rank gloo group).

Spawns of 4 gloo ranks at (data 2, pipe 2) and (data 1, pipe 4), against
JAX's functions on the same mesh shape of the conftest's virtual CPU
devices, same weights and inputs:
- OPNet's pipelined forward at JAX's limit (rtol 2e-5, atol 2e-6);
- one train step's gradients, joined into JAX's stacked layout, against the
  gradients through JAX's schedule at its limit (rtol 2e-4, atol 1e-6),
  the padding exactly zero on both sides;
- the params after Adam within 1e-5 of JAX's step where |g| >= 1e-7, and
  the train metrics within 1e-6 relative;
- the generic engine on a tanh MLP (nothing OPNet-shaped): forward against
  the plain chain, gradients against plain autodiff (as JAX's
  `test_gpipe_engine_is_model_agnostic`).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import PartitionSpec as P

from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
from objectpermanence_tpu.parallel.mesh import make_pipe_mesh as jax_make_pipe_mesh
from objectpermanence_tpu.parallel.pipeline import (
    _make_gpipe_per_shard, make_pipelined_opnet_forward as jax_pp_forward,
    make_pipelined_opnet_train_step as jax_pp_train_step, opnet_pipeline_stages as jax_stages,
    stack_stage_param_list as jax_stack_list, stack_stage_params as jax_stack_params,
)
from objectpermanence_tpu.train.losses import total_loss as jax_total_loss
from objectpermanence_tpu_torch.models.convert import (
    params_from_jax, pipeline_stages_from_jax, pipeline_stages_to_jax,
)
from objectpermanence_tpu_torch.parallel.mesh import make_pipe_mesh
from objectpermanence_tpu_torch.parallel.pipeline import (
    make_gpipe_forward, make_gpipe_train_step, opnet_stage_shapes, opnet_stage_trees,
)
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_dp_workers import GENERIC_WIDTHS, LR, NARROW, mp_batch, pp_suite, start
from torch_lane import one_torch_thread  # noqa: F401

GRAD_FLOOR = 1e-7
PIPES = [2, 4]


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_flat(tree[key], f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(tree[key])
    return out


@pytest.fixture(scope="module")
def jax_opnet():
    return jax.device_get(jax_get_model_spec("opnet").init(jax.random.PRNGKey(2), NARROW))


@pytest.mark.parametrize("num_stages", PIPES)
def test_converter_round_trip_is_jax_union_layout(jax_opnet, num_stages):
    mesh = jax_make_pipe_mesh(n_data=4 // num_stages, n_pipe=num_stages)
    stacked = jax.device_get(jax_stack_params(jax_opnet, mesh, num_stages=num_stages))
    stages = pipeline_stages_from_jax(stacked, opnet_stage_shapes(NARROW, num_stages))
    state = params_from_jax(jax_opnet)
    for got, want in zip(stages, opnet_stage_trees(state, num_stages)):
        want = {f"{k}.{leaf}": v for k, sub in want.items() for leaf, v in sub.items()}
        assert list(got) == sorted(want)
        for key, value in got.items():
            assert torch.equal(value, want[key]), key
    back = _flat(pipeline_stages_to_jax(stages))
    for key, value in _flat(stacked).items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_converter_pads_uneven_trees_as_jax():
    a = {"lstm": {"w": np.ones((3, 8), np.float32)}}
    b = {"head": {"w": np.full((5, 2), 2.0, np.float32)}}
    mesh = jax_make_pipe_mesh(n_data=4, n_pipe=2)
    want = _flat(jax.device_get(jax_stack_list([a, b], mesh)))
    got = _flat(pipeline_stages_to_jax([params_from_jax(a), params_from_jax(b)]))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    shapes = [{"lstm": {"w": (3, 8)}}, {"head": {"w": (5, 2)}}]
    stages = pipeline_stages_from_jax(_tree(want), shapes)
    assert torch.equal(stages[0]["lstm.w"], torch.ones(3, 8))
    assert torch.equal(stages[1]["head.w"], torch.full((5, 2), 2.0))


def _tree(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def test_engine_rejects_a_pipe_width_that_is_not_the_stage_count(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        mesh = make_pipe_mesh(n_data=1, n_pipe=1)
        three = [lambda local, transit, x: transit] * 3
        with pytest.raises(ValueError, match="3 stage functions"):
            make_gpipe_forward(mesh, three, transit_dim=4, out_dim=4)
        with pytest.raises(ValueError, match="3 stage functions"):
            make_gpipe_train_step(mesh, three, torch.optim.SGD([torch.zeros(1)], lr=0.1),
                                  transit_dim=4, out_dim=4)
    finally:
        dist.destroy_process_group()


def _generic(n_pipe):
    widths = GENERIC_WIDTHS[n_pipe]
    rng = np.random.RandomState(50 + n_pipe)
    ws = [rng.randn(widths[i], widths[i + 1]).astype(np.float32) * 0.3 for i in range(n_pipe)]
    x = rng.randn(8, 5, widths[0]).astype(np.float32)
    return widths, ws, x


def _jax_pp(n_pipe, params):
    """JAX's pipelined forward, the gradients through its schedule, and its
    train step's params and metrics, on a (4/n_pipe, n_pipe) mesh."""
    boxes, labels, mask = (jnp.asarray(a) for a in mp_batch(30))
    mesh = jax_make_pipe_mesh(n_data=4 // n_pipe, n_pipe=n_pipe)
    stacked = jax_stack_params(params, mesh, num_stages=n_pipe)
    y = np.asarray(jax_pp_forward(mesh, NARROW, num_microbatches=2, num_stages=n_pipe)(
        stacked, boxes))
    stage_fns, transit = jax_stages(NARROW, n_pipe)
    raw = jax.jit(shard_map(_make_gpipe_per_shard(stage_fns, 2, transit, 4), mesh=mesh,
                            in_specs=(P("pipe"), P("data")), out_specs=P("data"),
                            check_vma=False))
    grads = jax.grad(lambda p: jax_total_loss(raw(p, boxes), labels, mask, False)[0])(stacked)
    grads = _flat(jax.device_get(grads))
    optimizer = optax.adam(LR)
    step = jax_pp_train_step(mesh, NARROW, optimizer, num_microbatches=2, num_stages=n_pipe)
    after, _, metrics = step(stacked, optimizer.init(stacked), boxes, labels, mask)
    return y, grads, _flat(jax.device_get(after)), {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module", params=PIPES)
def runs(request, tmp_path_factory, jax_opnet):
    """(n_pipe, each rank's arrays and metrics, JAX's results)."""
    n_pipe = request.param
    out = tmp_path_factory.mktemp(f"pp{n_pipe}")
    save_params(out / "pp_init.npz", params_from_jax(jax_opnet))
    widths, ws, x = _generic(n_pipe)
    np.savez(out / "pp_generic.npz", x=x, **{f"w{i}": w for i, w in enumerate(ws)})
    wait = start(pp_suite, 4, out, str(out), n_pipe)
    try:
        jax_run = _jax_pp(n_pipe, jax_opnet)
    finally:
        wait()
    ranks = []
    for rank in range(4):
        with np.load(out / f"pp{n_pipe}_rank{rank}.npz") as blob:
            got = {k: blob[k] for k in blob.files}
        ranks.append((got, json.loads((out / f"pp{n_pipe}_rank{rank}.json").read_text())))
    return n_pipe, ranks, jax_run


def _stage_arrays(ranks, n_pipe, prefix):
    """The pipe ranks' (data index 0) stage tensors under `prefix`, in
    stage order, as state_dicts."""
    return [{k[len(prefix):]: torch.from_numpy(v) for k, v in ranks[p][0].items()
             if k.startswith(prefix)} for p in range(n_pipe)]


def test_pp_forward_matches_jax(runs):
    for got, _ in runs[1]:
        np.testing.assert_allclose(got["y"], runs[2][0], rtol=2e-5, atol=2e-6)


def test_pp_grads_match_jax_in_every_real_region(runs):
    n_pipe, ranks, jax_run = runs
    got = _flat(pipeline_stages_to_jax(_stage_arrays(ranks, n_pipe, "grad/")))
    want = jax_run[1]
    assert sorted(got) == sorted(want)
    shapes = opnet_stage_shapes(NARROW, n_pipe)
    for key, value in want.items():
        assert value.shape == got[key].shape, key
        np.testing.assert_allclose(got[key], value, rtol=2e-4, atol=1e-6, err_msg=key)
        path = key.split(".")
        for stage, tree in enumerate(shapes):      # the padding: exactly zero on both sides
            real = tree.get(path[0], {}).get(path[1])
            pad = np.ones(value.shape[1:], bool)
            if real is not None:
                pad[tuple(slice(0, n) for n in real)] = False
            assert np.all(value[stage][pad] == 0.0) and np.all(got[key][stage][pad] == 0.0)


def test_pp_step_params_and_metrics_match_jax(runs):
    n_pipe, ranks, jax_run = runs
    got = _flat(pipeline_stages_to_jax(_stage_arrays(ranks, n_pipe, "param/")))
    grads = _flat(pipeline_stages_to_jax(_stage_arrays(ranks, n_pipe, "grad/")))
    for key, value in jax_run[2].items():
        ok = np.abs(grads[key]) >= GRAD_FLOOR
        np.testing.assert_allclose(got[key][ok], value[ok], rtol=0, atol=1e-5, err_msg=key)
        np.testing.assert_array_equal(got[key][~ok & (value == 0)], 0.0)
    for _, metrics in ranks:
        for key, value in jax_run[3].items():
            np.testing.assert_allclose(metrics[key], value, rtol=1e-6, err_msg=key)


def test_pp_ranks_of_a_stage_agree(runs):
    """Where two data ranks hold one stage, the step leaves them equal."""
    n_pipe, ranks, _ = runs
    for rank in range(n_pipe, 4):
        for key, value in ranks[rank][0].items():
            if key.startswith("param/"):
                np.testing.assert_array_equal(value, ranks[rank - n_pipe][0][key], err_msg=key)


def test_generic_engine_is_model_agnostic(runs):
    n_pipe, ranks, _ = runs
    widths, ws, x = _generic(n_pipe)
    ref = x
    for w in ws:
        ref = np.tanh(ref @ w)

    def ref_loss(ws_list):
        h = jnp.asarray(x)
        for w in ws_list:
            h = jnp.tanh(h @ w)
        return jnp.mean(h ** 2)

    ref_g = jax.grad(ref_loss)([jnp.asarray(w) for w in ws])
    for rank, (got, _) in enumerate(ranks):
        np.testing.assert_allclose(got["generic_y"], ref, rtol=2e-5, atol=2e-6)
        stage = rank % n_pipe
        np.testing.assert_allclose(got["generic_grad"], np.asarray(ref_g[stage]), rtol=2e-4,
                                   atol=1e-6)
