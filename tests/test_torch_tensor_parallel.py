"""The port's tensor parallelism (`parallel/sharding.py`) against the JAX
package's (`objectpermanence_tpu/parallel/sharding.py`).

Without a spawn: the port's rule (`tp_param_shardings`) against JAX's for
every OPNet leaf, at the narrow and the flagship width, over model widths
that divide every sharded dim and one (3) that does not: the same dims, a
warning for each replicated leaf and a raise under `strict` on both sides,
and each model rank's part (`models/convert.py::shard_from_jax`) equal to
what JAX's `shard_params` puts on that device (`addressable_shards`).

One spawn of 4 gloo ranks, (data 2, model 2): two Adam steps of OPNet
through `make_train_step` on the sharded model against JAX's
`make_train_step` over `shard_params(make_mesh(2, 2))` on the conftest's
virtual CPU devices: each rank's shards before the steps equal to JAX's,
the losses within 1e-6 relative, and each rank's shards after within
Adam's 1e-5 of JAX's where every step's |g| >= 1e-7 (Adam magnifies
rounding below, `tests/test_torch_train.py`).
"""

import json
import warnings

import jax
import numpy as np
import pytest

from objectpermanence_tpu.models.registry import init_model as jax_init_model
from objectpermanence_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from objectpermanence_tpu.parallel.mesh import make_mesh as jax_make_mesh
from objectpermanence_tpu.parallel.sharding import shard_params as jax_shard_params
from objectpermanence_tpu.parallel.sharding import tp_param_shardings as jax_tp_param_shardings
from objectpermanence_tpu.train.loop import make_optimizer as jax_make_optimizer
from objectpermanence_tpu.train.loop import make_train_step as jax_make_train_step
from objectpermanence_tpu_torch.models.convert import (
    params_from_jax, shard_from_jax, shards_to_jax,
)
from objectpermanence_tpu_torch.parallel.dryrun import OPNET_CONFIG
from objectpermanence_tpu_torch.parallel.sharding import tp_param_shardings
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_dp_workers import LR, MP_STEPS, NARROW, mp_batch, start, tp_steps
from torch_lane import one_torch_thread  # noqa: F401

GRAD_FLOOR = 1e-7
CONFIGS = {"narrow": NARROW, "flagship": OPNET_CONFIG}


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_flat(tree[key], f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = tree[key]
    return out


def _spec_dim(sharding):
    spec = tuple(sharding.spec)
    dims = [d for d, axis in enumerate(spec) if axis is not None]
    return dims[0] if dims else None


def _device_parts(array, devices):
    by_device = {s.device: np.array(s.data, copy=True) for s in array.addressable_shards}
    return [by_device[d] for d in devices]


@pytest.fixture(scope="module")
def jax_params():
    return {name: jax.device_get(jax_init_model("opnet", cfg, 0)[1])
            for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("width", [2, 3, 4])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_rule_and_shards_match_jax(jax_params, config, width):
    params = jax_params[config]
    mesh = jax_make_mesh(n_data=1, n_model=width)
    with warnings.catch_warnings(record=True) as jax_warned:
        warnings.simplefilter("always")
        want = {k: _spec_dim(v) for k, v in _flat(jax_tp_param_shardings(params, mesh)).items()}
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        dims = tp_param_shardings(params_from_jax(params), width)
    assert dims == want
    assert len(warned) == len(jax_warned)
    assert all("replicating this leaf" in str(w.message) for w in warned)
    full = _flat(params)

    sharded = _flat(jax_shard_params(params, mesh))
    devices = list(mesh.devices.flat)
    parts = [shard_from_jax(params, dims, width, k) for k in range(width)]
    for name, array in sharded.items():
        for k, part in enumerate(_device_parts(array, devices)):
            np.testing.assert_array_equal(parts[k][name].numpy(), part, err_msg=name)
    joined = _flat(shards_to_jax(parts, dims))
    for name, value in full.items():
        np.testing.assert_array_equal(joined[name], np.asarray(value), err_msg=name)

    if warned:
        with pytest.raises(ValueError, match="refusing silent replication"):
            jax_tp_param_shardings(params, mesh, strict=True)
        with pytest.raises(ValueError, match="refusing silent replication"):
            tp_param_shardings(params_from_jax(params), width, strict=True)
    else:
        assert tp_param_shardings(params_from_jax(params), width, strict=True) == dims


def test_width_three_replicates_the_narrow_gates(jax_params):
    """At the narrow width, model 3 divides the video LSTM's 96 gate columns
    but not the attention LSTM's 64: a mixed case of the rule."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dims = tp_param_shardings(params_from_jax(jax_params["narrow"]), 3)
    assert dims["att_lstm.w_ih"] is None and dims["video_lstm.w_hh"] == 1


def _jax_tp_steps(params):
    """JAX's two steps over `shard_params(make_mesh(2, 2))`: each device's
    shards before and after (in rank order: device d*2+m is rank d*2+m),
    and the losses."""
    from objectpermanence_tpu.models.registry import get_model_spec
    mesh = jax_make_mesh(n_data=2, n_model=2)
    devices = list(mesh.devices.flat)
    spec = get_model_spec("opnet")
    params = jax_shard_params(params, mesh, strict=True)
    # the step donates its arguments: read the shards first
    init = {name: _device_parts(array, devices) for name, array in _flat(params).items()}
    optimizer = jax_make_optimizer(LR)
    state = optimizer.init(params)
    step = jax_make_train_step(spec, optimizer)
    losses = []
    for s in range(MP_STEPS):
        boxes, labels, mask = (jax.device_put(a, jax_batch_sharding(mesh)) for a in mp_batch(20 + s))
        params, state, metrics = step(params, state, boxes, labels, mask, jax.random.PRNGKey(s))
        losses.append(float(metrics["loss"]))
    after = {name: _device_parts(array, devices) for name, array in _flat(params).items()}
    return init, after, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_params):
    """(each rank's arrays and losses, JAX's shards and losses)."""
    out = tmp_path_factory.mktemp("tp")
    save_params(out / "tp_init.npz", params_from_jax(jax_params["narrow"]))
    wait = start(tp_steps, 4, out, str(out))
    try:
        jax_run = _jax_tp_steps(jax_params["narrow"])
    finally:
        wait()
    ranks = []
    for rank in range(4):
        with np.load(out / f"tp_rank{rank}.npz") as blob:
            arrays = {k: blob[k] for k in blob.files}
        ranks.append((arrays, json.loads((out / f"tp_rank{rank}.json").read_text())))
    return ranks, jax_run


def test_tp_shards_before_the_steps_are_jax_devices(runs):
    tp_run, (init, _, _) = runs
    for name, parts in init.items():
        for rank, part in enumerate(parts):
            np.testing.assert_array_equal(tp_run[rank][0][f"init/{name}"], part, err_msg=name)


def test_tp_steps_match_jax(runs):
    tp_run, (_, after, jax_losses) = runs
    for arrays, losses in tp_run:
        np.testing.assert_allclose(losses, jax_losses, rtol=1e-6)
    checked = 0
    for name, parts in after.items():
        for rank, part in enumerate(parts):
            arrays = tp_run[rank][0]
            mask = np.all([np.abs(arrays[f"grad{s}/{name}"]) >= GRAD_FLOOR
                           for s in range(MP_STEPS)], axis=0)
            np.testing.assert_allclose(arrays[f"param/{name}"][mask], part[mask], rtol=0,
                                       atol=1e-5, err_msg=name)
            checked += int(mask.sum())
    assert checked > 0


def test_tp_ranks_of_a_model_group_agree(runs):
    """The two data ranks of one model index hold the same shards after
    the steps (the gradients were averaged over data)."""
    tp_run = runs[0]
    for rank in (0, 1):
        a, b = tp_run[rank][0], tp_run[rank + 2][0]
        for key in a:
            if key.startswith("param/"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
