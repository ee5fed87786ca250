"""The port's SiamRPN tracker (`objectpermanence_tpu_torch/models/siam.py`)
against the JAX package's on the CPU, on inputs made from a numpy seed.

- host math (`generate_anchor`, `tracker_update`): exactly equal;
- `resize_linear_u8` against `cv2.resize` (INTER_LINEAR, uint8) and
  `get_subwindow` against JAX's (which calls cv2): bit for bit, 0 levels;
- the network at full width (3-96-256-384-384-256, 127 px exemplar, 271
  and 287 px search) with JAX's parameters crossed by `siam_params_from_jax`:
  `temple`'s kernels and `track_forward`'s delta and score within 1e-4 x
  max(1, max |JAX's|) (float32 convs, the same products summed in another
  order);
- the tracker over a drawn fixture sequence, on JAX's trajectory: the
  reasoner's state equal to JAX's on every frame, and on each hidden frame
  the port's network and update, from JAX's state, within 0.1 px of JAX's
  position and size and 1e-4 of its best score (the network's last-bit gap
  moves a decoded box by thousandths of a pixel). Where the two networks
  pick different anchors, JAX's penalized scores of the two must be within
  1e-4 (a near-tie: 5x the score gap `chip_smoke.py` logs between the card
  and the CPU; at most one such frame).
  A free run is not compared: one near-tie picked the other way moves every
  later frame.

The weights are JAX's `siam_train_init` with each batch norm's running
statistics set to the batch statistics of fixture crops
(`calibrate_batch_norm`): the init's mean 0, var 1 would leave the pixels'
scale in the features and saturate every score at 0 or 1.
"""

import jax
import numpy as np
import pytest
import torch

from objectpermanence_tpu.models import siam as jax_siam
from objectpermanence_tpu.train import siam_loop as jax_loop
from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
from objectpermanence_tpu_torch.models import siam
from objectpermanence_tpu_torch.models.convert import (
    siam_params_from_jax, siam_state_dict_from_reference,
)
from objectpermanence_tpu_torch.train.siam_loop import calibrate_batch_norm
from objectpermanence_tpu_torch.utils.checkpoint import save_params

cv2 = pytest.importorskip("cv2")

NET_RTOL = 1e-4
STATE_PX, SCORE_TOL, TIE_PSCORE = 0.1, 1e-4, 1e-4
RATIOS, SCALES = (0.33, 0.5, 1, 2, 3), (8,)
FRAMES = 60


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread: torch's thread pool stalls when the
    lane's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fixture_crops(frames, count=4):
    """Exemplar and search crops (float NCHW) around the frame centre."""
    picks = frames[:: max(len(frames) // count, 1)][:count]
    z = np.stack([jax_siam.get_subwindow(f, (160, 120), 100, 127, f.mean((0, 1))) for f in picks])
    x = np.stack([jax_siam.get_subwindow(f, (160, 120), 200, 271, f.mean((0, 1))) for f in picks])
    return (z.transpose(0, 3, 1, 2).astype(np.float32),
            x.transpose(0, 3, 1, 2).astype(np.float32))


@pytest.fixture(scope="module")
def sequence():
    """A 60-frame fixture scene (the snitch hidden on 25 of them), BGR
    frames as cv2 decodes them, and its detections in the pickle schema."""
    scene = make_scene(7, num_frames=FRAMES)
    frames = np.ascontiguousarray(draw_frames(scene, seed=7)[..., ::-1])
    visible = scene["visible"]
    dets = {"bb": [scene["boxes"][t, visible[t]].astype(np.float32) for t in range(FRAMES)],
            "labels": [scene["classes"][visible[t]].astype(np.int64) for t in range(FRAMES)]}
    return frames, dets


@pytest.fixture(scope="module")
def weights(sequence):
    """(JAX params, the port's SiamRPN) with the same calibrated values."""
    params = jax_loop.siam_train_init(jax.random.PRNGKey(3))
    z, x = fixture_crops(sequence[0])
    _, _, stats = jax.jit(jax_loop.pair_forward_train)(params, z, x)
    for layer, (mean, var) in zip(params["features"], stats):
        layer["bn"]["mean"], layer["bn"]["var"] = mean, var
    params = jax.device_get(params)
    model = siam.SiamRPN()
    model.load_state_dict(siam_params_from_jax(params))
    return params, model.eval()


@pytest.mark.parametrize("score_size", [19, 21])
def test_generate_anchor_exact(score_size):
    ours = siam.generate_anchor(8, SCALES, RATIOS, score_size)
    want = jax_siam.generate_anchor(8, SCALES, RATIOS, score_size)
    assert ours.dtype == want.dtype and np.array_equal(ours, want)


@pytest.mark.parametrize("case", ["plain", "huge_log_sizes", "tiny_target"])
def test_tracker_update_exact(case):
    rng = np.random.RandomState({"plain": 0, "huge_log_sizes": 1, "tiny_target": 2}[case])
    anchors = siam.generate_anchor(8, SCALES, RATIOS, 19)
    n = len(anchors)
    delta = rng.normal(0, 0.5, (4, n)).astype(np.float32)
    sz = np.array([40.0, 30.0])
    if case == "huge_log_sizes":
        delta[2:] = rng.uniform(-120, 120, (2, n))   # exp() over- and underflows
    if case == "tiny_target":
        sz = np.array([1e-14, 3.0])
    score = rng.uniform(0, 1, n).astype(np.float32)
    hanning = np.hanning(19)
    window = np.tile(np.outer(hanning, hanning).flatten(), 5)
    args = (anchors, window, np.array([150.0, 100.0]), sz, 0.9, 0.04, 0.44, 0.45)
    with np.errstate(all="ignore"):
        ours = siam.tracker_update(delta, score, *args)
        want = jax_siam.tracker_update(delta, score, *args)
    for a, b in zip(ours, want):
        np.testing.assert_array_equal(a, b)


RESIZES = [(300, 300, 271), (150, 150, 127), (400, 400, 271), (254, 254, 127), (33, 33, 127),
           (90, 90, 127), (127, 127, 271), (200, 200, 287), (2, 2, 127), (37, 90, 127)]


@pytest.mark.parametrize("h,w,size", RESIZES)
def test_resize_matches_cv2_bit_for_bit(h, w, size):
    image = np.random.RandomState(h * 1000 + w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    ours = siam.resize_linear_u8(image, size, size)
    want = cv2.resize(image, (size, size))
    assert ours.dtype == np.uint8 and ours.shape == want.shape
    assert np.array_equal(ours, want), int(np.abs(ours.astype(int) - want).max())


def test_resize_sweep_matches_cv2_bit_for_bit():
    """Every source side 2-40 px and 40 seeded sides up to 820 px, to the
    tracker's three crop sizes: 0 levels apart from cv2 everywhere."""
    rng = np.random.RandomState(11)
    sides = list(range(2, 41)) + list(rng.randint(41, 821, 40))
    for side in sides:
        image = rng.randint(0, 256, (side, side, 3)).astype(np.uint8)
        for size in (127, 271, 287):
            assert np.array_equal(siam.resize_linear_u8(image, size, size),
                                  cv2.resize(image, (size, size))), (side, size)


@pytest.mark.parametrize("pos,original,model_sz", [
    ((160.0, 120.0), 101, 127), ((3.0, 5.0), 230, 271), ((317.4, 236.6), 64, 127),
    ((100.5, 80.5), 287, 287), ((40.0, 200.0), 400, 287)])
def test_get_subwindow_matches_jax(sequence, pos, original, model_sz):
    frame = sequence[0][30]
    avg = frame.mean(axis=(0, 1))
    ours = siam.get_subwindow(frame, pos, original, model_sz, avg)
    want = jax_siam.get_subwindow(frame, pos, original, model_sz, avg)
    assert ours.shape == (model_sz, model_sz, 3) and np.array_equal(ours, want)


def test_siam_params_from_jax_is_exact(weights):
    params, model = weights
    state = siam_params_from_jax(params)
    assert list(state) == list(model.state_dict())
    assert np.array_equal(state["featureExtract.5.running_var"],
                          params["features"][1]["bn"]["var"])
    assert np.array_equal(state["conv_cls1.weight"], params["conv_cls1"]["w"])
    assert all(v.dtype == torch.float32 for v in state.values())


@pytest.mark.parametrize("instance", [271, 287])
def test_network_matches_jax_at_full_width(weights, sequence, instance):
    params, model = weights
    frame = sequence[0][10]
    z = jax_siam.get_subwindow(frame, (150, 110), 90, 127, frame.mean((0, 1)))
    x = jax_siam.get_subwindow(frame, (150, 110), 190, instance, frame.mean((0, 1)))
    z = z.transpose(2, 0, 1)[None].astype(np.float32)
    x = x.transpose(2, 0, 1)[None].astype(np.float32)
    kernels = jax_siam.temple(params, z)
    delta, score = jax_siam.track_forward(params, kernels, x)
    with torch.inference_mode():
        ours_k = model.temple(torch.from_numpy(z))
        ours_delta, ours_score = model.track_forward(ours_k, torch.from_numpy(x))
    size = (instance - 127) // 8 + 1
    assert ours_k[0].shape == (20, 256, 4, 4) and ours_k[1].shape == (10, 256, 4, 4)
    assert ours_delta.shape == (4, 5 * size * size) and ours_score.shape == (5 * size * size,)
    for got, want in zip((*ours_k, ours_delta, ours_score), (*kernels, delta, score)):
        want = np.asarray(want)
        limit = NET_RTOL * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got.numpy() - want).max()) <= limit


class Replay:
    """JAX's tracker with the port's beside it: `init` and `track` return
    JAX's states, so both reasoners follow JAX's trajectory, and on every
    frame the port's network and update run from JAX's state (with the
    port's own exemplar kernels, from the same crop) and are compared."""

    def __init__(self, jax_tracker, tracker):
        self.jax, self.port = jax_tracker, tracker
        self.frames, self.other_picks, self.max_px, self.bad = 0, 0, 0.0, []

    def port_state(self, state):
        return siam.SiamState(pos=state.pos, sz=state.sz, kernels=self.kernels,
                              window=state.window, anchors=state.anchors,
                              avg_chans=state.avg_chans, instance_size=state.instance_size,
                              im_hw=state.im_hw)

    def init(self, im, pos, sz):
        state = self.jax.init(im, pos, sz)
        self.kernels = self.port.init(im, pos, sz).kernels
        assert self.port.init(im, pos, sz).instance_size == state.instance_size
        return state

    def track(self, state, im):
        want = self.jax.track(state, im)
        ours = self.port_state(state)
        crop, scale_z = self.port.search(ours, im)
        jax_delta, jax_score = (np.asarray(a) for a in jax_siam.track_forward(
            self.jax.params, state.kernels, crop.transpose(2, 0, 1)[None].astype(np.float32)))
        # JAX's own network outputs through the port's update: JAX's state exactly
        same = self.port.update(ours, jax_delta, jax_score, scale_z)
        assert np.array_equal(same.pos, want.pos) and np.array_equal(same.sz, want.sz)
        delta, score, _ = self.port.forward(ours, im)
        got = self.port.update(ours, delta, score, scale_z)
        self.frames += 1
        cfg = self.port.cfg
        pscore = [siam.penalized_scores(d, s, state.anchors, state.window, state.sz * scale_z,
                                        cfg["penalty_k"], cfg["window_influence"])[2]
                  for d, s in ((jax_delta, jax_score), (delta, score))]
        best_jax, best_port = (int(np.argmax(p)) for p in pscore)
        if best_jax != best_port:
            self.other_picks += 1
            if pscore[0][best_jax] - pscore[0][best_port] > TIE_PSCORE:
                self.bad.append((self.frames, "pick"))
            return want
        px = max(np.abs(got.pos - want.pos).max(), np.abs(got.sz - want.sz).max())
        self.max_px = max(self.max_px, float(px))
        if px > STATE_PX or abs(got.score - want.score) > SCORE_TOL:
            self.bad.append((self.frames, float(px)))
        return want


@pytest.mark.parametrize("cfg", [{}, {"adaptive": True}], ids=["vot", "adaptive"])
def test_tracker_states_match_jax_per_frame(weights, sequence, cfg):
    """The detector_tracker reasoner over the sequence, frame by frame, on
    the same detections and frames: the port's reasoner keeps JAX's state on
    every frame, and on each hidden frame the port's network and update,
    from JAX's state, give JAX's position and size. JAX crops with
    cv2.resize, the port with its own (bit-identical, above). `adaptive`
    picks the 287 px search for the small snitch."""
    params, model = weights
    frames, dets = sequence
    jax_tracker = jax_siam.SiamRPNTracker(params, cfg)
    replay = Replay(jax_tracker, siam.SiamRPNTracker(model, cfg, device="cpu"))
    ours = siam.ObjectDetectWithSiamTracker(replay)
    want = jax_siam.ObjectDetectWithSiamTracker(jax_tracker)
    for t in range(len(frames)):
        ours.track_for_frame(frames[t], t, dets)
        want.track_for_frame(frames[t], t, dets)
        assert ours.snitch_visible == want.snitch_visible
        assert ours.tracker_initiated == want.tracker_initiated
        for key, value in want.state.items():
            assert np.array_equal(np.asarray(ours.state[key]), np.asarray(value)), (t, key)
    assert replay.frames >= 20 and not replay.bad, replay.bad
    assert replay.other_picks <= 1
    assert want.tracker_state.instance_size == (287 if cfg else 271)


def test_model_sources_load(weights, tmp_path):
    """`load_siam_model` from an upstream-style `.pth` (with batch norm's
    `num_batches_tracked`, as newer torch saves it), an `.npz`, and a
    `siam_train_main` directory; a wrong blob raises."""
    _, model = weights
    state = model.state_dict()
    upstream = dict(state)
    upstream["featureExtract.1.num_batches_tracked"] = torch.tensor(7)
    torch.save(upstream, tmp_path / "SiamRPNVOT.model")
    save_params(tmp_path / "ckpt" / "final.npz", state)
    for source in (tmp_path / "SiamRPNVOT.model", tmp_path / "ckpt" / "final.npz",
                   tmp_path / "ckpt"):
        loaded = siam.load_siam_model(str(source)).state_dict()
        assert all(torch.equal(loaded[k], state[k]) for k in state), source
    del upstream["conv_r1.bias"]
    with pytest.raises(ValueError, match="missing"):
        siam_state_dict_from_reference(upstream)


def test_calibrate_batch_norm_matches_jax_stats(weights, sequence):
    """Running statistics from the pairs' batch statistics: the fixture's
    calibrated values, which JAX's `pair_forward_train` gave."""
    params, _ = weights
    model = siam.SiamRPN()
    state = siam_params_from_jax(params)
    model.load_state_dict(state)
    for _, bn in model.feature_layers():
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
    z, x = fixture_crops(sequence[0])
    calibrate_batch_norm(model, torch.from_numpy(z), torch.from_numpy(x))
    for key in state:
        if key.endswith(("running_mean", "running_var")):
            want = state[key].numpy()
            got = model.state_dict()[key].numpy()
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key


def test_export_script_carries_a_jax_siam_checkpoint(weights, tmp_path):
    """`scripts/export_torch_weights.py --model_type siam`: an orbax tree as
    JAX's `siam_train_main` saves it -> the port's npz, exactly; then
    `build_siam_reasoner` loads the directory that holds it as `final.npz`."""
    import importlib.util
    from pathlib import Path
    from objectpermanence_tpu.utils.checkpoint import save_params as jax_save_params
    params, model = weights
    jax_save_params(tmp_path / "jax" / "final", params)
    script = Path(__file__).resolve().parent.parent / "scripts" / "export_torch_weights.py"
    spec = importlib.util.spec_from_file_location("export_torch_weights", script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.main(["--model_type", "siam", str(tmp_path / "jax" / "final"),
                 str(tmp_path / "port" / "final.npz")])
    reasoner = siam.build_siam_reasoner(str(tmp_path / "port"), device="cpu")
    loaded = reasoner.tracker.model.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())
