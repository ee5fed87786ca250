"""The port's data parallelism (`parallel/mesh.py`, `parallel/data_parallel.py`,
`parallel/fsdp.py`, `train/loop.py` with a mesh) at world 2 over gloo on the
CPU, against the JAX package's steps on a 2-device mesh of the conftest's
virtual CPU devices and against the port's own single process.

One spawn of two ranks (`torch_dp_workers.dp_suite`) runs every scenario;
the tests read what the ranks wrote. Inputs come from numpy seeds, weights
from the JAX inits through the weight bridge. Checked:
- three train steps (a full batch, then two ragged ones, the last leaving
  rank 1 only zero-weight rows) of `opnet`, `opnet_no_labels`,
  `opnet_att_ce` and `opnet_moe` under DDP: the metrics (the global batch's)
  within 1e-6 of JAX's, the first step's gradients within rtol 1e-4, atol
  1e-6 of JAX's, and the params within 1e-5 of JAX's and of the port's one
  process where every step's |g| >= 1e-7 (Adam magnifies rounding below,
  `tests/test_torch_train.py`);
- `training_main` under the mesh, two epochs of fixture splits with a
  ragged last batch: both ranks' histories equal, the losses within rtol
  1e-4 of JAX's `training_main(mesh=make_mesh(n_data=2))` and 1e-5 of the
  port's one process, mean IoUs within 1e-3 (a box within rounding of an
  integer pixel can flip one pixel);
- FSDP2: each large leaf (>= 4096 elements) holds 1/2 of its elements per
  rank, the small ones are replicated, and two steps equal the single-device
  step and JAX's FSDP step on the 2-device mesh within the same limits.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectpermanence_tpu.data.ingest import ingest_directory as jax_ingest_directory
from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
from objectpermanence_tpu.models.registry import init_model as jax_init_model
from objectpermanence_tpu.parallel.fsdp import make_fsdp_train_step as jax_make_fsdp_train_step
from objectpermanence_tpu.parallel.fsdp import shard_train_state as jax_shard_train_state
from objectpermanence_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from objectpermanence_tpu.parallel.mesh import make_mesh as jax_make_mesh
from objectpermanence_tpu.train.loop import make_optimizer as jax_make_optimizer
from objectpermanence_tpu.train.loop import make_train_step as jax_make_train_step
from objectpermanence_tpu.train.loop import training_main as jax_training_main
from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
from objectpermanence_tpu_torch.data.ingest import ingest_directory
from objectpermanence_tpu_torch.models.convert import params_from_jax
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.parallel.mesh import make_mesh
from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step, training_main
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_dp_workers import (
    BATCH, FRAMES, FSDP_CFG, LR, MODELS, NARROW, dp_suite, fsdp_batch, run_steps, spawn,
    step_batches,
)

GRAD_FLOOR = 1e-7
TRAIN_VIDEOS, DEV_VIDEOS = 11, 8   # batches of 8: the second holds 3 real rows


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_init(name, seed):
    return jax.device_get(jax_init_model(name, MODELS.get(name, FSDP_CFG), seed)[1])


def _training_config(path, **extra):
    return {"batch_size": BATCH, "inference_batch_size": BATCH, "num_epochs": 2,
            "print_step": 1, "learning_rate": LR, "checkpoints_path": str(path / "ckpt"),
            "train_sample_dir": "x", "train_labels_dir": "x", "train_containment_file": "x",
            "dev_sample_dir": "x", "dev_labels_dir": "x", "dev_containment_file": "x", **extra}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    for name in MODELS:
        save_params(out / f"{name}_init.npz", params_from_jax(_jax_init(name, 2)))
    save_params(out / "training_init.npz", params_from_jax(_jax_init("opnet", 0)))
    save_params(out / "fsdp_init.npz", params_from_jax(
        jax.device_get(jax_init_model("opnet", FSDP_CFG, 1)[1])))
    train = write_fixture_dataset(out / "train", num_videos=TRAIN_VIDEOS, seed=2,
                                  num_frames=FRAMES)
    dev = write_fixture_dataset(out / "dev", num_videos=DEV_VIDEOS, seed=3, num_frames=FRAMES)
    (out / "training.json").write_text(json.dumps(_training_config(out / "world2",
                                                                   device="cpu")))
    spawn(dp_suite, 2, out, str(out), list(MODELS), [str(p) for p in train],
          [str(p) for p in dev], timeout=400)
    return out, train, dev


def _load(path):
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


def _jax_steps(name, params):
    """JAX's train step over the three batches, each sharded over a 2-device
    mesh -> (metrics per step, first step's gradients, params after)."""
    spec = jax_get_model_spec(name, MODELS[name])
    optimizer = jax_make_optimizer(LR)
    step = jax_make_train_step(spec, optimizer)
    sharding = jax_batch_sharding(jax_make_mesh(n_data=2))
    params = jax.tree.map(jnp.array, params)
    state = optimizer.init(params)
    metrics, first_grads = [], None
    for boxes, labels, mask, tracks, weights, _ in step_batches():
        put = [jax.device_put(a, sharding) for a in (boxes, labels, mask, weights, tracks)]
        params, state, got = step(params, state, *put[:3], jax.random.PRNGKey(3), *put[3:])
        metrics.append({k: float(v) for k, v in got.items()})
        if first_grads is None:
            first_grads = params_from_jax(jax.device_get(state.inner_state[0].mu))
    return metrics, first_grads, params_from_jax(jax.device_get(params))


def _one_process(name):
    spec = get_model_spec(name, MODELS[name])
    model = spec.build(MODELS[name])
    model.load_state_dict(params_from_jax(_jax_init(name, 2)))
    metrics, grads = run_steps(spec, model)
    return metrics, grads, {n: p.detach().numpy() for n, p in model.state_dict().items()}


def _conditioned(grads, key):
    return np.all([np.abs(g[key]) >= GRAD_FLOOR for g in grads], axis=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_ddp_steps_match_jax_and_one_process(world2, name):
    out, _, _ = world2
    saved = _load(out / f"{name}_world2.npz")
    metrics = json.loads((out / f"{name}_world2.json").read_text())
    params = {k[len("param/"):]: v for k, v in saved.items() if k.startswith("param/")}
    first_grads = {k[len("grad0/"):]: v for k, v in saved.items() if k.startswith("grad0/")}
    jax_metrics, jax_grads, jax_params = _jax_steps(name, _jax_init(name, 2))
    one_metrics, one_grads, one_params = _one_process(name)

    for ours, theirs, alone in zip(metrics, jax_metrics, one_metrics):
        assert sorted(ours) == sorted(theirs) == sorted(alone)
        for key in ours:
            np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=1e-6, err_msg=key)
            np.testing.assert_allclose(ours[key], alone[key], rtol=0, atol=1e-6, err_msg=key)
    for key, grad in first_grads.items():
        np.testing.assert_allclose(grad, jax_grads[key].numpy() / 0.1, rtol=1e-4, atol=1e-6,
                                   err_msg=key)
        np.testing.assert_allclose(grad, one_grads[0][key], rtol=1e-4, atol=1e-7, err_msg=key)
    for key, value in params.items():
        conditioned = _conditioned(one_grads, key)
        assert conditioned.any(), key
        np.testing.assert_allclose(value[conditioned], jax_params[key].numpy()[conditioned],
                                   rtol=0, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(value[conditioned], one_params[key][conditioned], rtol=0,
                                   atol=1e-5, err_msg=key)


def test_training_main_under_the_mesh_matches_jax_and_one_process(world2, tmp_path, capsys):
    out, (train_pred, train_labels, train_cont), (dev_pred, dev_labels, dev_cont) = world2
    histories = [json.loads((out / f"history_rank{r}.json").read_text()) for r in (0, 1)]
    for h in histories:
        for record in h:
            record.pop("epoch_seconds")
    assert histories[0] == histories[1]
    history = histories[0]
    ckpt = out / "world2" / "ckpt" / "opnet"
    assert (ckpt / "resume" / "epoch_0002" / "state.npz").exists()
    assert list(ckpt.glob("*.npz"))

    jax_train = jax_ingest_directory(train_pred, train_labels, 6, train_cont)
    jax_dev = jax_ingest_directory(dev_pred, dev_labels, 6, dev_cont)
    jax_result = jax_training_main(
        jax_get_model_spec("opnet"), jax_train, jax_dev,
        _training_config(tmp_path / "jax"), NARROW, mesh=jax_make_mesh(n_data=2))

    init = params_from_jax(_jax_init("opnet", 0))

    def build(config, generator):
        model = get_model_spec("opnet").build(config, generator)
        model.load_state_dict(init)
        return model

    spec = dataclasses.replace(get_model_spec("opnet"), build=build)
    alone = training_main(spec, ingest_directory(train_pred, train_labels, 6, train_cont),
                          ingest_directory(dev_pred, dev_labels, 6, dev_cont),
                          _training_config(tmp_path / "port", device="cpu"), NARROW)
    capsys.readouterr()

    assert len(history) == len(jax_result.history) == len(alone.history) == 2
    for ours, theirs, one in zip(history, jax_result.history, alone.history):
        assert ours["learning_rate"] == pytest.approx(theirs["learning_rate"], rel=1e-6)
        for split in ("train", "dev"):
            np.testing.assert_allclose(ours[split]["loss"], theirs[split]["loss"], rtol=1e-4)
            np.testing.assert_allclose(ours[split]["loss"], one[split]["loss"], rtol=1e-5)
            for key in ("mean_iou", "containment_mean_iou"):
                np.testing.assert_allclose(ours[split][key], theirs[split][key], atol=1e-3)
                np.testing.assert_allclose(ours[split][key], one[split][key], atol=1e-3)
    final = _load(out / "training_world2.npz")
    for key, value in alone.model.state_dict().items():
        np.testing.assert_allclose(final[key], value.numpy(), rtol=0, atol=1e-4, err_msg=key)


def test_fsdp_large_leaves_really_sharded(world2):
    out, _, _ = world2
    ranks = [json.loads((out / f"fsdp_rank{r}.json").read_text()) for r in (0, 1)]
    shapes = {n: p.shape for n, p in get_model_spec("opnet").build(FSDP_CFG).named_parameters()}
    sharded = 0
    for rank in ranks:
        assert rank["shardings"] == ranks[0]["shardings"]
        for name, shape in shapes.items():
            size = int(np.prod(shape))
            local = rank["local"][name]
            assert rank["placed"][name] == (local is not None)
            if size >= 2 ** 12:
                dim = rank["shardings"][name]
                assert dim is not None and local is not None, name
                assert int(np.prod(local)) * 2 == size, (name, shape, local)
                assert shape[dim] == max(shape), name
                sharded += 1
            else:
                assert rank["shardings"][name] is None and local is None, name
    assert sharded >= 2 * 3   # the LSTM gate matrices at least, on both ranks


def test_fsdp_step_matches_single_device_and_jax(world2):
    out, _, _ = world2
    full = _load(out / "fsdp_world2.npz")
    losses = [json.loads((out / f"fsdp_rank{r}.json").read_text())["losses"] for r in (0, 1)]
    assert losses[0] == losses[1]

    params = jax.device_get(jax_init_model("opnet", FSDP_CFG, 1)[1])
    spec = get_model_spec("opnet")
    model = spec.build(FSDP_CFG)
    model.load_state_dict(params_from_jax(params))
    optimizer = make_optimizer(model.parameters(), LR)
    step = make_train_step(spec, optimizer)
    ref_losses, grads = [], []
    for seed in (3, 4):
        boxes, labels, mask = (torch.from_numpy(a) for a in fsdp_batch(seed))
        ref_losses.append(float(step(model, boxes, labels, mask)["loss"]))
        grads.append({n: p.grad.numpy().copy() for n, p in model.named_parameters()})

    jax_spec = jax_get_model_spec("opnet", FSDP_CFG)
    jax_optimizer = jax_make_optimizer(LR)
    mesh = jax_make_mesh(n_data=2)
    jax_state = jax_optimizer.init(params)
    jax_step = jax_make_fsdp_train_step(jax_spec, jax_optimizer, mesh, params, jax_state)
    jax_p, jax_o = jax_shard_train_state(params, jax_state, mesh)
    for seed in (3, 4):
        jax_p, jax_o, jax_metrics = jax_step(jax_p, jax_o, *fsdp_batch(seed),
                                             jax.random.PRNGKey(0))
    jax_params = params_from_jax(jax.device_get(jax_p))

    np.testing.assert_allclose(losses[0], ref_losses, rtol=1e-5)
    np.testing.assert_allclose(losses[0][-1], float(jax_metrics["loss"]), rtol=1e-5)
    for key, value in model.state_dict().items():
        conditioned = _conditioned(grads, key)
        assert conditioned.any(), key
        np.testing.assert_allclose(full[key][conditioned], value.numpy()[conditioned], rtol=0,
                                   atol=1e-5, err_msg=key)
        np.testing.assert_allclose(full[key][conditioned], jax_params[key].numpy()[conditioned],
                                   rtol=0, atol=1e-5, err_msg=key)


def test_make_mesh_without_a_process_group_raises():
    with pytest.raises(ValueError, match="process group"):
        make_mesh()
