"""The port's detector training under data parallelism at world 2 over gloo
on the CPU (`models/detector/training.py::data_parallel_detector`,
`train/detector_loop.py` with a mesh): the counterparts of
`tests/test_detector_dp.py` at its TINY config (64 x 96 frames, GroupNorm)
and a frozen-BN twin, whose batch-norm tensors are trained buffers that DDP
does not reduce (the step averages their gradients itself).

One spawn of two ranks (`torch_dp_workers.detector_dp`). Checked:
- two recipe steps (clip 10, decay 5e-4, momentum 0.9, warmup) of a batch
  of 4, 2 per rank, with JAX's draws for each image: the loss parts (the
  mean of the ranks') within 1e-5 relative of JAX's mesh step over a
  2-device mesh (`under_mesh=True`: its XLA gather path) and of the port's
  one process, and the params after within 1e-6 of both;
- `train_detector(mesh=...)` for an epoch at batch 5, rounded to 6: the
  ranks' params bitwise equal, and the run equal to the port's one process
  at batch 6 (losses within 1e-5 relative, params within 1e-6), the draws
  being the whole batch's on every rank;
- epoch resume under the mesh: the resumed call runs epoch 2 only, keeps
  only the newest resume state, moves the params and ends where an
  uninterrupted one-process run ends.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from objectpermanence_tpu.models.detector import detector as jdet
from objectpermanence_tpu.models.detector import training as jtr
from objectpermanence_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from objectpermanence_tpu.parallel.mesh import make_mesh as jax_make_mesh
from objectpermanence_tpu.parallel.mesh import replicate as jax_replicate
from objectpermanence_tpu.train.detector_loop import warmup_schedule as jax_warmup_schedule
from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
from objectpermanence_tpu_torch.models.detector.convert import state_dict_from_jax
from objectpermanence_tpu_torch.models.detector.detector import DetectorConfig
from objectpermanence_tpu_torch.train.detector_loop import train_detector
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_dp_workers import (
    DET_BATCH, DET_DECAY, DET_LOOP, DET_LR, DET_MOMENTUM, DET_NORMS, DET_TINY, DET_WARMUP,
    detector_dp, detector_step_batch, detector_steps, spawn,
)
from torch_lane import one_torch_thread  # noqa: F401

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6
STEPS = 2


def _tiny_dataset(root):
    """`tests/test_detector_dp.py`'s set: 10 frames of 64 x 96, a gold
    square each."""
    from PIL import Image

    rng = np.random.RandomState(7)
    images_dir = root / "imgs"
    images_dir.mkdir()
    rows = []
    for i in range(10):
        img = np.zeros((64, 96, 3), np.uint8)
        x, y = rng.randint(5, 60), rng.randint(5, 30)
        img[y:y + 20, x:x + 20] = [255, 220, 0]
        rows.append([f"img_{i}.png", "small_gold_spl_metal", x, y, 20, 20])
        Image.fromarray(img).save(images_dir / f"img_{i}.png")
    csv_path = root / "ann.csv"
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["filename", "object_class", "X", "Y", "width", "height"])
        writer.writerows(rows)
    return images_dir, csv_path


def _jax_case(norm):
    jcfg = jdet.DetectorConfig(**dict(DET_TINY, backbone_norm=norm))
    params = jax.device_get(jax.jit(lambda k: jdet.detector_init(k, jcfg))(jax.random.PRNGKey(0)))
    anchors = [jnp.asarray(a) for a in jdet.anchor_lib.pyramid_anchors(
        jcfg.feature_shapes(), jcfg.strides, jcfg.anchor_sizes)]
    return jcfg, params, anchors


def _jax_draws(key, batch, num_anchors, num_rois):
    """JAX's own uniforms for `detection_loss(..., key)`, per image."""
    keys = jax.random.split(key, batch * 2).reshape(batch, 2, -1)

    def pair(k, n):
        r1, r2 = jax.random.split(k)
        return np.asarray(jax.random.uniform(r1, (n,))), np.asarray(jax.random.uniform(r2, (n,)))

    rpn = [pair(keys[i, 0], num_anchors) for i in range(batch)]
    roi = [pair(keys[i, 1], num_rois) for i in range(batch)]
    return [np.stack(x) for x in ([p for p, _ in rpn], [n for _, n in rpn],
                                  [p for p, _ in roi], [n for _, n in roi])]


KEYS = [jax.random.PRNGKey(100 + s) for s in range(STEPS)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    out = tmp_path_factory.mktemp("detdp")
    for norm in DET_NORMS:
        jcfg, params, anchors = _jax_case(norm)
        save_params(out / f"det_{norm}_init.npz",
                    state_dict_from_jax(params, jcfg.backbone_layers))
        num_anchors = sum(a.shape[0] for a in anchors)
        num_rois = jcfg.rpn_post_nms_top_n + detector_step_batch()[1].shape[1]
        draws = {}
        for s, key in enumerate(KEYS):
            for field, value in zip(("rpn_pos", "rpn_neg", "roi_pos", "roi_neg"),
                                    _jax_draws(key, DET_BATCH, num_anchors, num_rois)):
                draws[f"{s}_{field}"] = value
        np.savez(out / f"det_{norm}_draws.npz", **draws)
    images_dir, csv_path = _tiny_dataset(out)
    spawn(detector_dp, 2, out, str(out), str(images_dir), str(csv_path), timeout=400)
    return out, images_dir, csv_path


def _load(path):
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


def _jax_mesh_steps(norm):
    """JAX's recipe steps with the batch sharded over a 2-device mesh."""
    jcfg, params, anchors = _jax_case(norm)
    mesh = jax_make_mesh(n_data=2)
    optimizer = optax.chain(optax.clip_by_global_norm(10.0), optax.add_decayed_weights(DET_DECAY),
                            optax.sgd(jax_warmup_schedule(DET_LR, DET_WARMUP),
                                      momentum=DET_MOMENTUM))
    params = jax.device_put(params, jax_replicate(mesh))
    state = optimizer.init(params)
    step = jtr.make_detector_train_step(jcfg, anchors, optimizer, under_mesh=True)
    batch = [jax.device_put(a, jax_batch_sharding(mesh)) for a in detector_step_batch()]
    parts = []
    for key in KEYS:
        params, state, got = step(params, state, *batch, key)
        parts.append({k: float(v) for k, v in got.items()})
    return parts, state_dict_from_jax(jax.device_get(params), jcfg.backbone_layers)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("norm", DET_NORMS)
def test_dp_step_matches_jax_mesh_and_one_process(world2, norm):
    out, _, _ = world2
    ranks = [json.loads((out / f"det_{norm}_rank{r}.json").read_text()) for r in (0, 1)]
    assert ranks[0] == ranks[1]
    parts, state = ranks[0]["parts"], _load(out / f"det_{norm}_world2.npz")
    jax_parts, jax_state = _jax_mesh_steps(norm)
    one_parts, one_state = detector_steps(norm, out)
    for ours, theirs, alone in zip(parts, jax_parts, one_parts):
        assert set(ours) == set(theirs) == set(alone)
        for key in ours:
            assert _rel(ours[key], theirs[key]) <= LOSS_RTOL, (key, ours[key], theirs[key])
            assert _rel(ours[key], alone[key]) <= LOSS_RTOL, (key, ours[key], alone[key])
    buffers = [k for k in state if k.endswith("running_var")]
    assert bool(buffers) == (norm == "frozen")
    init = state_dict_from_jax(_jax_case(norm)[1], DET_TINY["backbone_layers"])
    assert all(not np.array_equal(state[k], init[k].numpy()) for k in buffers)
    for key, value in jax_state.items():
        np.testing.assert_allclose(state[key], value.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)
        np.testing.assert_allclose(state[key], one_state[key].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


def _one_process(images_dir, csv_path, tmp_path, epochs):
    return train_detector(DetectionDataset(images_dir, csv_path), None,
                          DetectorConfig(**DET_TINY), num_epochs=epochs, batch_size=6,
                          checkpoint_dir=str(tmp_path / f"one{epochs}"), **DET_LOOP)


def test_dp_loop_matches_one_process(world2, tmp_path):
    out, images_dir, csv_path = world2
    histories = [json.loads((out / f"det_loop_rank{r}.json").read_text()) for r in (0, 1)]
    assert histories[0] == histories[1]
    params = [_load(out / f"det_loop_rank{r}.npz") for r in (0, 1)]
    for key in params[0]:
        np.testing.assert_array_equal(params[0][key], params[1][key], err_msg=key)
    assert (out / "loop" / "final.npz").exists()
    alone = _one_process(images_dir, csv_path, tmp_path, 1)
    loop = histories[0]["loop"]
    assert [h["epoch"] for h in loop] == [1] and len(loop[0]["train_losses"]) == 2
    for ours, theirs in zip(loop[0]["train_losses"], alone["history"][0]["train_losses"]):
        assert np.isfinite(ours) and _rel(ours, theirs) <= LOSS_RTOL
    for key, value in alone["params"].items():
        np.testing.assert_allclose(params[0][key], value.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


def test_dp_epoch_resume(world2, tmp_path):
    out, images_dir, csv_path = world2
    record = json.loads((out / "det_loop_rank0.json").read_text())
    assert [h["epoch"] for h in record["first"]] == [1]
    assert [h["epoch"] for h in record["second"]] == [2]
    assert sorted(p.name for p in (out / "resume" / "resume").iterdir()) == ["epoch_0002"]
    first, second = _load(out / "det_first_rank0.npz"), _load(out / "det_second_rank0.npz")
    assert not np.allclose(first["roi_heads.box_predictor.cls_score.weight"],
                           second["roi_heads.box_predictor.cls_score.weight"])
    straight = _one_process(images_dir, csv_path, tmp_path, 2)
    for key, value in straight["params"].items():
        np.testing.assert_allclose(second[key], value.numpy(), rtol=0, atol=1e-5, err_msg=key)
