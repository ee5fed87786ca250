"""The port's SiamRPN training (`objectpermanence_tpu_torch/train/siam_loop.py`),
tracker evaluation (`analysis/tracker_eval.py`) and perfect-perception
generator (`datagen/perfect_perception.py`) against the JAX package's on
the CPU, on inputs made from a numpy seed, at the network's full width.

Tolerances, with their reasons:
- the training forward's delta and score logits and each layer's batch
  statistics: 1e-4 x max(1, max |JAX's|) (float32 convs and reductions in
  another order);
- the loss parts given JAX's sample masks: rtol 1e-5; each gradient within
  1e-4 x max(1, max |JAX's|): sums over B x 1805 anchors and the convs'
  spatial positions in another order;
- after 1 and 3 optimizer steps (clip, SGD with momentum at the warmup-cosine
  rate, BN EMA): each parameter and running statistic within 1e-5 x max(1,
  max |JAX's|) (the steps' gradient gaps times the rate plus float32's
  rounding of the updates); the first step's loss parts at rtol 1e-5, the
  later steps' at rtol 1e-3: at rates of 1e-3 to 5e-3 the untrained
  regression loss swings by several times its value from step to step, so
  weights within the 1e-5 above give losses that far apart;
- `evaluate_pairs`: the mean IoU within 1e-4 and the centre-hit rate equal
  (the arg-max anchor is the same; the decoded boxes carry the forward's
  last-bit gap);
- the schedule: within 1e-6 of optax's, relative (numpy's float32 cosine
  and XLA's differ in the last bits, which the schedule's end magnifies to
  a few ulps of the rate);
  `_crop_pair`, the OTB metrics and the perception pickles: exactly equal.

JAX's `balanced_sample` draws from `jax.random`, the port's from a
`torch.Generator`; the loss takes the masks as arguments, so the test
passes those JAX drew.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from objectpermanence_tpu.analysis import tracker_eval as jax_tracker_eval
from objectpermanence_tpu.datagen import perfect_perception as jax_pp
from objectpermanence_tpu.datagen.simulator import simulate_dataset
from objectpermanence_tpu.models.detector.training import balanced_sample as jax_balanced_sample
from objectpermanence_tpu.train import siam_loop as jax_loop
from objectpermanence_tpu_torch.analysis import tracker_eval
from objectpermanence_tpu_torch.datagen import perfect_perception
from objectpermanence_tpu_torch.models import siam
from objectpermanence_tpu_torch.models.convert import siam_params_from_jax
from objectpermanence_tpu_torch.train import siam_loop

RTOL = 1e-4
LOSS_RTOL, STEP_RTOL, LATER_LOSS_RTOL, SCHEDULE_RTOL = 1e-5, 1e-5, 1e-3, 1e-6
BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread: torch's thread pool stalls when the
    lane's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got - want).max()) <= rtol * max(1.0, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def pairs():
    """B pairs of pixel crops (float NCHW, values 0-255) and gt boxes."""
    rng = np.random.RandomState(0)
    z = rng.randint(0, 256, (BATCH, 3, 127, 127)).astype(np.float32)
    x = rng.randint(0, 256, (BATCH, 3, 271, 271)).astype(np.float32)
    gt = np.array([[5.0, -10.0, 50.0, 45.0], [0.0, 8.0, 35.0, 60.0]], np.float32)
    return z, x, gt


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax_loop.siam_train_init(jax.random.PRNGKey(0)))


def port_model(params):
    model = siam.SiamRPN()
    model.load_state_dict(siam_params_from_jax(params))
    return model


def jax_masks(key, gt):
    """The (matches, sampled, positive) masks JAX's train step draws with
    `key`, as the port's (B, Na) tensors."""
    _, anchors_xyxy = jax_loop._anchor_arrays()
    from objectpermanence_tpu.ops.boxes import pairwise_iou_xyxy
    out = []
    for g, r in zip(gt, jax.random.split(key, len(gt))):
        gt_xyxy = jnp.array([g[0] - g[2] / 2, g[1] - g[3] / 2, g[0] + g[2] / 2,
                             g[1] + g[3] / 2])[None]
        iou = pairwise_iou_xyxy(gt_xyxy, anchors_xyxy)[0]
        matches = jnp.where(iou >= 0.6, 0, -2)
        matches = jnp.where(iou < 0.3, -1, matches)
        matches = jnp.where(iou == jnp.max(iou), 0, matches)
        sampled, pos = jax_balanced_sample(r, matches, 64, 0.25)
        out.append([np.asarray(m) for m in (matches, sampled, pos)])
    return tuple(torch.from_numpy(np.stack(parts)) for parts in zip(*out))


def test_pair_forward_train_and_bn_stats_match_jax(params, pairs):
    z, x, _ = pairs
    want_delta, want_score, want_stats = jax.jit(jax_loop.pair_forward_train)(params, z, x)
    delta, score, stats = siam_loop.pair_forward_train(port_model(params), torch.from_numpy(z),
                                                       torch.from_numpy(x))
    assert delta.shape == (BATCH, 4, siam_loop.NUM_ANCHORS_TOTAL)
    assert score.shape == (BATCH, 2, siam_loop.NUM_ANCHORS_TOTAL)
    assert close(delta, want_delta) and close(score, want_score)
    assert len(stats) == 5
    for (mean, var), (want_mean, want_var) in zip(stats, want_stats):
        assert close(mean, want_mean) and close(var, want_var)


def test_masks_from_jax_draws_match(pairs):
    """The port's masks from JAX's own uniforms equal the masks JAX draws."""
    _, _, gt = pairs
    key = jax.random.PRNGKey(5)
    want = jax_masks(key, gt)
    draws = [jax.random.split(r) for r in jax.random.split(key, len(gt))]
    pos_draws = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(a, (1805,)))
                                           for a, _ in draws]))
    neg_draws = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(b, (1805,)))
                                           for _, b in draws]))
    _, anchors_xyxy = siam_loop.anchor_arrays()
    ours = siam_loop.siam_pair_masks(torch.from_numpy(gt), anchors_xyxy, pos_draws, neg_draws)
    for a, b in zip(ours, want):
        assert torch.equal(a, b)
    assert int(ours[2].sum(1).max()) <= 16 and int(ours[1].sum(1).min()) == 64


def test_pair_loss_and_grads_match_jax(params, pairs):
    z, x, gt = pairs
    key = jax.random.PRNGKey(1)
    anchors_cxcywh, anchors_xyxy = jax_loop._anchor_arrays()

    def loss_fn(p):
        delta, score, _ = jax_loop.pair_forward_train(p, z, x)
        cls_l, reg_l = jax.vmap(lambda d, s, g, r: jax_loop.siam_pair_loss(
            r, d, s, g, anchors_cxcywh, anchors_xyxy))(delta, score, gt,
                                                       jax.random.split(key, BATCH))
        return jnp.mean(cls_l) + jnp.mean(reg_l), (cls_l, reg_l)

    (want_loss, (want_cls, want_reg)), want_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = port_model(params)
    delta, score, _ = siam_loop.pair_forward_train(model, torch.from_numpy(z),
                                                   torch.from_numpy(x))
    cxcywh, _ = siam_loop.anchor_arrays()
    cls_l, reg_l = siam_loop.siam_pair_loss(delta, score, torch.from_numpy(gt), cxcywh,
                                            *jax_masks(key, gt))
    loss = cls_l.mean() + reg_l.mean()
    loss.backward()
    np.testing.assert_allclose(cls_l.detach().numpy(), want_cls, rtol=LOSS_RTOL)
    np.testing.assert_allclose(reg_l.detach().numpy(), want_reg, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    want = siam_params_from_jax(jax.device_get(want_grads))
    for name, param in model.named_parameters():
        assert close(param.grad, want[name]), name


def _optax_schedule(spe, epochs, peak=5e-3, init=0.0):
    return optax.warmup_cosine_decay_schedule(init, peak, spe, epochs * spe, peak * 0.01)


@pytest.mark.parametrize("spe,epochs,init", [(2, 3, 0.0), (5, 2, 0.0), (3, 4, 1e-3)])
def test_schedule_matches_optax(spe, epochs, init):
    ours = siam_loop.warmup_cosine_schedule(init, 5e-3, spe, epochs * spe, 5e-5)
    want = _optax_schedule(spe, epochs, init=init)
    for count in range(epochs * spe + 3):
        a, b = ours(count), float(want(count))
        assert abs(a - b) <= SCHEDULE_RTOL * b, (count, a, b)
    with pytest.raises(ValueError):
        siam_loop.warmup_cosine_schedule(0.0, 5e-3, spe, spe, 5e-5)


_JAX_STEPS = {}


def _jax_step(max_norm):
    """JAX's optax chain and jitted train step, compiled once per clip."""
    if max_norm not in _JAX_STEPS:
        optimizer = optax.chain(optax.clip_by_global_norm(max_norm),
                                optax.sgd(_optax_schedule(2, 3, init=1e-3), momentum=0.9))
        _JAX_STEPS[max_norm] = optimizer, jax_loop.make_siam_train_step(optimizer)
    return _JAX_STEPS[max_norm]


@pytest.mark.parametrize("steps,max_norm", [(1, 10.0), (3, 10.0), (3, 0.5)])
def test_optimizer_steps_match_optax(params, pairs, steps, max_norm):
    """`make_siam_train_step` against JAX's with optax's chain: the loss,
    every parameter and running statistic after 1 and 3 steps, with the
    shipped clip of 10 (inactive here) and one of 0.5 (active). The rate
    starts at 1e-3 so that the first step moves the weights."""
    z, x, gt = pairs
    optimizer, jax_step = _jax_step(max_norm)
    jax_params, opt_state = params, optimizer.init(params)

    model = port_model(params)
    step = siam_loop.make_siam_train_step(
        siam_loop.make_siam_optimizer(model),
        siam_loop.warmup_cosine_schedule(1e-3, 5e-3, 2, 6, 5e-5), max_norm=max_norm)
    tz, tx, tgt = (torch.from_numpy(a) for a in (z, x, gt))
    for i in range(steps):
        key = jax.random.PRNGKey(10 + i)
        jax_params, opt_state, want = jax_step(jax_params, opt_state, z, x, gt, key)
        metrics = step(model, tz, tx, tgt, masks=jax_masks(key, gt))
        for name in ("loss", "cls", "reg"):
            np.testing.assert_allclose(float(metrics[name]), float(want[name]),
                                       rtol=LOSS_RTOL if i == 0 else LATER_LOSS_RTOL)
    assert step.count == steps
    want_state = siam_params_from_jax(jax.device_get(jax_params))
    for name, value in model.state_dict().items():
        assert close(value, want_state[name], STEP_RTOL), name
    moved = model.state_dict()["featureExtract.1.running_mean"]
    assert float(moved.abs().max()) > 0.0


def test_evaluate_pairs_matches_jax(params, pairs):
    """Frozen-BN eval with a padded last batch (5 pairs, batch 4)."""
    z, x, gt = pairs
    rng = np.random.RandomState(3)
    z5 = np.concatenate([z, z[::-1], z[:1]]) + rng.uniform(0, 1, (5, 1, 1, 1)).astype(np.float32)
    x5 = np.concatenate([x, x[::-1], x[:1]])
    gt5 = np.concatenate([gt, gt[::-1], gt[:1]]) + rng.uniform(-4, 4, (5, 4)).astype(np.float32)
    want = jax_loop.evaluate_pairs(params, z5, x5, gt5, batch_size=4)
    ours = siam_loop.evaluate_pairs(port_model(params), z5, x5, gt5, batch_size=4)
    assert set(ours) == {"mean_iou", "center_hit"}
    assert abs(ours["mean_iou"] - want["mean_iou"]) <= 1e-4
    assert ours["center_hit"] == want["center_hit"]


@pytest.mark.parametrize("box", [(150.0, 110.0, 40.0, 20.0), (2.0, 200.0, 12.0, 30.0)])
def test_crop_pair_matches_jax(box):
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (240, 320, 3)).astype(np.uint8) for _ in range(2)]
    later = (box[0] + 6.0, box[1] - 3.0, box[2] * 1.1, box[3])
    ours = siam_loop._crop_pair(frames, box, later, np.random.RandomState(9))
    want = jax_loop._crop_pair(frames, box, later, np.random.RandomState(9))
    for a, b in zip(ours, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_siam_train_main_then_track(tmp_path):
    """Two epochs on 4 fixture-cropped pairs (2 held out, batch 2: a step an
    epoch) on the CPU, then the `detector_tracker` reasoner from the
    checkpoint directory."""
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    scene = make_scene(3, num_frames=40)
    frames = draw_frames(scene, seed=3)
    rng = np.random.RandomState(0)
    crops = []
    for t in range(0, 20, 5):
        x1, y1, x2, y2 = scene["boxes"][t, 1]
        a1, b1, a2, b2 = scene["boxes"][t + 3, 1]
        crops.append(siam_loop._crop_pair([frames[t], frames[t + 3]],
                                          (x1, y1, x2 - x1, y2 - y1),
                                          (a1, b1, a2 - a1, b2 - b1), rng))
    np.savez(tmp_path / "pairs.npz", **{k: np.stack(v) for k, v in zip("z x gt".split(),
                                                                        zip(*crops))})
    result = siam_loop.siam_train_main(tmp_path / "pairs.npz", tmp_path / "ckpt", num_epochs=2,
                                       batch_size=2, holdout=2, print_step=1, device="cpu")
    assert [h["epoch"] for h in result["history"]] == [1, 2]
    assert all(np.isfinite(h["mean_iou"]) for h in result["history"])
    assert result["checkpoint"] == str(tmp_path / "ckpt" / "final.npz")
    reasoner = siam.build_siam_reasoner(str(tmp_path / "ckpt"), device="cpu")
    trained = result["model"].state_dict()
    assert all(torch.equal(v, trained[k]) for k, v in
               reasoner.tracker.model.state_dict().items())
    boxes = [[5, 5, 25, 25]] * 2 + [[]] * 3
    dets = {"bb": [np.array([b], np.float32).reshape(-1, 4) for b in boxes],
            "labels": [np.array([140] * len(b[:1]), np.int64) for b in boxes]}
    for t in range(5):
        reasoner.track_for_frame(frames[t], t, dets)
    assert not reasoner.snitch_visible and np.isfinite(reasoner.state["target_pos"]).all()


def test_ope_metrics_match_jax():
    rng = np.random.RandomState(6)
    gt = np.column_stack([rng.uniform(0, 200, (50, 2)), rng.uniform(5, 60, (50, 2))])
    pred = gt + rng.normal(0, 8, gt.shape)
    pred[::7, 2] = 0.0    # zero-area boxes
    assert tracker_eval.ope_metrics(gt, pred) == jax_tracker_eval.ope_metrics(gt, pred)
    np.testing.assert_array_equal(tracker_eval.center_error(gt, pred),
                                  jax_tracker_eval.center_error(gt, pred))


def test_evaluate_tracker_matches_jax():
    """OPE over two short drawn sequences with the SiamRPN trackers at the
    same calibrated weights: the averaged metrics within 1e-6 (the frames'
    boxes differ by hundredths of a pixel at most)."""
    from objectpermanence_tpu.models import siam as jax_siam
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    params = jax_loop.siam_train_init(jax.random.PRNGKey(2))
    sequences = []
    for seed in (1, 2):
        scene = make_scene(seed, num_frames=8)
        frames = [np.ascontiguousarray(f) for f in draw_frames(scene, seed=seed)]
        b = scene["boxes"][:, 1]
        sequences.append({"frames": frames,
                          "gt": np.column_stack([b[:, :2], b[:, 2:] - b[:, :2]])})
    crops = [siam_loop._crop_pair([s["frames"][0]] * 2, s["gt"][0], s["gt"][0],
                                  np.random.RandomState(0)) for s in sequences]
    z = np.stack([c[0] for c in crops]).transpose(0, 3, 1, 2).astype(np.float32)
    x = np.stack([c[1] for c in crops]).transpose(0, 3, 1, 2).astype(np.float32)
    _, _, stats = jax.jit(jax_loop.pair_forward_train)(params, z, x)
    for layer, (mean, var) in zip(params["features"], stats):
        layer["bn"]["mean"], layer["bn"]["var"] = mean, var
    params = jax.device_get(params)
    ours = tracker_eval.evaluate_tracker(
        siam.SiamRPNTracker(port_model(params), device="cpu"), sequences)
    want = jax_tracker_eval.evaluate_tracker(jax_siam.SiamRPNTracker(params), sequences)
    assert len(ours["per_sequence"]) == 2
    for key in ("success_auc", "precision_20px", "mean_iou"):
        assert abs(ours[key] - want[key]) <= 1e-6, key


@pytest.mark.parametrize("mode,camera_motion", [("visible_only", False), ("uncontained", False),
                                                ("visible_only", True)])
def test_perfect_perception_matches_jax(tmp_path, mode, camera_motion):
    scenes_dir, labels_dir = simulate_dataset(tmp_path / "sim", num_videos=2, seed=3,
                                              num_frames=40, camera_motion=camera_motion)
    outs = {}
    for tag, module in (("ours", perfect_perception), ("jax", jax_pp)):
        gen = module.PerfectPerceptionGenerator(scenes_dir, labels_dir, tmp_path / tag,
                                                visible_ratio=0.99, mode=mode)
        outs[tag] = (gen.generate(), gen.generate_snitch_visible_frames())
    assert outs["ours"][0] == outs["jax"][0] and len(outs["ours"][0]) == 2
    assert outs["ours"][1].read_bytes() == outs["jax"][1].read_bytes()
    for name in outs["ours"][0]:
        with open(tmp_path / "ours" / f"{name}.pkl", "rb") as a, \
                open(tmp_path / "jax" / f"{name}.pkl", "rb") as b:
            mine, want = pickle.load(a), pickle.load(b)
        for key in ("bb", "labels"):
            assert len(mine[key]) == len(want[key]) == 40
            assert all(p.dtype == q.dtype and np.array_equal(p, q)
                       for p, q in zip(mine[key], want[key]))
    scene = json.loads(next(scenes_dir.glob("*.json")).read_text())
    assert perfect_perception.contained_frame_ranges(scene) == jax_pp.contained_frame_ranges(scene)
