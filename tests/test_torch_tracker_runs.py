"""The port's tracker drivers against the JAX package's scripts on the CPU:
`experiments/tracker_benchmark.py` and `experiments/siam_run.py` (JAX's
imported as `scripts.<name>`).

Both run on the same seeds, each on its own root, with the same SiamRPN
weights: JAX's `siam_train_init(PRNGKey(4))` with each batch norm's
statistics calibrated on fixture crops (the init's mean 0, var 1 saturate
every score), as an upstream-style `.pth` both packages load
(`tests/test_torch_trackers.py`'s). Tolerances, with their reasons:
- the fixture set (scenes, labels, videos, detection frames, perception
  pickles) byte for byte, and the `--existing-src --limit` symlink farm
  link for link;
- OPE of `detector_heuristic`: every metric equal (host code on the same
  detections);
- `detector_tracker`: each predicted box within 1 px of JAX's on at most 1%
  of the coordinates (`tests/test_torch_trackers.py`'s: the network's
  last-bit gap moves the tracked floats by hundredths of a pixel, which can
  carry an `int()` across an integer);
- raw SiamRPN: two float32 tracker runs can part for good at one frame (an
  arg-max, a rounded crop origin), so it is held frame by frame by replay:
  from each of JAX's states, the port's next state within 0.1 px of JAX's
  (`chip_smoke.py`'s STATE_PX); the driver's OPE row is the OTB harness's
  score of the port's own run;
- `siam_run data`: the pair npz holds JAX's arrays, equal (not its bytes:
  the zip records its write time); `train` on the structure of its
  checkpoint and history; `bench` runs the port's `tracker_benchmark` in
  this process, on the trained checkpoint.
"""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

import scripts.siam_run as jax_siam_run
import scripts.tracker_benchmark as jax_tb
from objectpermanence_tpu.analysis import tracker_eval as jax_tracker_eval
from objectpermanence_tpu.models import siam as jax_siam
from objectpermanence_tpu.train import siam_loop as jax_loop
from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
from objectpermanence_tpu_torch.experiments import siam_run, tracker_benchmark
from objectpermanence_tpu_torch.infer.trackers import read_video_bgr
from objectpermanence_tpu_torch.models.convert import siam_params_from_jax
from objectpermanence_tpu_torch.models.siam import build_siam_reasoner
from torch_experiment_helpers import files, jax_main, run_quiet
from torch_lane import one_torch_thread  # noqa: F401

VIDEOS, FRAMES = 2, 24
PX_SHARE, STATE_PX = 1e-2, 0.1
OPE_KEYS = {"success_auc", "precision_20px", "mean_iou"}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Calibrated seeded weights saved as an upstream-style `.pth`."""
    params = jax_loop.siam_train_init(jax.random.PRNGKey(4))
    frames = draw_frames(make_scene(11, num_frames=8), seed=11)
    z = np.stack([jax_siam.get_subwindow(f, (160, 120), 100, 127, f.mean((0, 1))) for f in frames])
    x = np.stack([jax_siam.get_subwindow(f, (160, 120), 200, 271, f.mean((0, 1))) for f in frames])
    _, _, stats = jax.jit(jax_loop.pair_forward_train)(
        params, z.transpose(0, 3, 1, 2).astype(np.float32),
        x.transpose(0, 3, 1, 2).astype(np.float32))
    for layer, (mean, var) in zip(params["features"], stats):
        layer["bn"]["mean"], layer["bn"]["var"] = mean, var
    path = tmp_path_factory.mktemp("siam") / "SiamRPNVOT.model"
    torch.save(siam_params_from_jax(jax.device_get(params)), path)
    return path


@pytest.fixture(scope="module")
def benched(tmp_path_factory, weights):
    """Both benchmarks on fresh fixture sets with the same weights; JAX's
    raw SiamRPN trajectories are recorded for the replay."""
    base = tmp_path_factory.mktemp("trackbench")
    argv = ["--videos", VIDEOS, "--frames", FRAMES, "--weights", weights]
    runs = []
    real = jax_tracker_eval.evaluate_tracker

    def recorded(tracker, sequences):
        runs.append((tracker, sequences))
        return real(tracker, sequences)

    with pytest.MonkeyPatch.context() as mp:   # JAX's script imports it at its call
        mp.setattr(jax_tracker_eval, "evaluate_tracker", recorded)
        jax_main(jax_tb, ["--root", base / "jax", *argv, "--cpu"])
    run_quiet(tracker_benchmark.main, [str(a) for a in
                                       ["--root", base / "port", *argv, "--device", "cpu"]])
    return base / "jax", base / "port", runs[0]


def _results(root):
    return json.loads((root / "results.json").read_text())


def test_fixture_set_bytes_equal(benched):
    jax_root, port_root, _ = benched
    keep = ("scenes", "labels", "videos", "det_images", "od_perception")
    ours = {k: v for k, v in files(port_root).items() if k.split(os.sep)[0] in keep}
    theirs = {k: v for k, v in files(jax_root).items() if k.split(os.sep)[0] in keep}
    assert ours == theirs
    assert len([k for k in ours if k.endswith(".avi")]) == VIDEOS


def test_heuristic_and_detector_tracker_match_jax(benched):
    jax_root, port_root, _ = benched
    ours, theirs = _results(port_root), _results(jax_root)
    assert set(ours) == set(theirs) == {"detector_heuristic", "detector_tracker", "siamrpn_raw"}
    for name, row in ours.items():
        assert set(row) == set(theirs[name]) and OPE_KEYS <= set(row), name
    for key in OPE_KEYS:
        assert ours["detector_heuristic"][key] == theirs["detector_heuristic"][key], key
    for model in ("detector_heuristic", "detector_tracker"):
        for path in sorted((jax_root / f"results_{model}").glob("*_bb.json")):
            a = np.array(json.loads((port_root / f"results_{model}" / path.name).read_text()))
            b = np.array(json.loads(path.read_text()))
            diff = np.abs(a - b)
            assert a.shape == (FRAMES, 4) and diff.max() <= 1, (model, path.name)
            assert (diff > 0).mean() <= (PX_SHARE if model == "detector_tracker" else 0), model


def test_raw_siamrpn_by_replay(benched, weights):
    """From each of JAX's states the port's tracker decides the next frame
    as JAX's did; the port's own run is what its row scores."""
    _, port_root, (jax_tracker, sequences) = benched
    ours = build_siam_reasoner(str(weights), device="cpu").tracker
    worst = 0.0
    videos = sorted((port_root / "videos").glob("*.avi"))
    for seq, video in zip(sequences, videos, strict=True):
        frames, gt = seq["frames"], seq["gt"]
        x, y, w, h = gt[0]
        pos, sz = np.array([x + w / 2, y + h / 2]), np.array([w, h], dtype=np.float64)
        want = jax_tracker.init(frames[0], pos, sz)
        state = ours.init(frames[0], pos, sz)
        for frame in frames[1:]:
            got = ours.track(dataclasses.replace(state, pos=want.pos.copy(), sz=want.sz.copy()),
                             frame)
            want = jax_tracker.track(want, frame)
            worst = max(worst, float(np.abs(got.pos - want.pos).max()),
                        float(np.abs(got.sz - want.sz).max()))
        # the port decodes the same frames as the driver's harness
        assert np.array_equal(np.stack(read_video_bgr(video)[:len(frames)]), np.stack(frames))
    assert worst <= STATE_PX, worst
    row = _results(port_root)["siamrpn_raw"]
    assert all(0 <= row[k] <= 1 for k in OPE_KEYS), row


def test_existing_set_symlink_farm_matches_jax(benched, tmp_path):
    """`--existing-src --existing-videos --limit`: the same links, and with
    `--resume` the finished results are reused."""
    jax_root, _, _ = benched
    argv = ["--existing-src", jax_root, "--existing-videos", jax_root / "videos", "--limit", 1]
    jax_main(jax_tb, ["--root", tmp_path / "jax", *argv, "--cpu"])
    run_quiet(tracker_benchmark.main, [str(a) for a in
                                       ["--root", tmp_path / "port", *argv, "--device", "cpu"]])
    ours, theirs = files(tmp_path / "port" / "subset"), files(tmp_path / "jax" / "subset")
    assert ours == theirs and len(ours) == 4    # one video's four files
    assert all(v[0] == "link" for k, v in ours.items() if os.sep in k)
    rows = _results(tmp_path / "port")
    assert rows["detector_heuristic"] == pytest.approx(
        {**_results(tmp_path / "jax")["detector_heuristic"],
         "seconds": rows["detector_heuristic"]["seconds"]})
    calls = []
    real = tracker_benchmark.trackers.track_video

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracker_benchmark.trackers, "track_video", spy)
        run_quiet(tracker_benchmark.main, [str(a) for a in ["--root", tmp_path / "port", *argv,
                                                            "--resume", "--device", "cpu"]])
    assert not calls


def test_siam_run_stages(benched, tmp_path):
    """`data` against JAX's pair npz; `train` 2 epochs on 8 pairs (batch 4,
    2 held out: `siam_train_main`'s holdout, patched, as the driver's fixed
    256 needs 64 videos' pairs); `bench` through the port's
    tracker_benchmark, in process."""
    jax_root, port_root, _ = benched
    argv = ["--train-src", jax_root, "--train-videos", jax_root / "videos", "--pairs", 8]
    jax_main(jax_siam_run, ["data", "--root", tmp_path / "jax", *argv])
    run_quiet(siam_run.main, [str(a) for a in ["data", "--root", tmp_path / "port", *argv]])
    with np.load(tmp_path / "port" / "pairs.npz") as ours, \
            np.load(tmp_path / "jax" / "pairs.npz") as theirs:
        assert sorted(ours.files) == sorted(theirs.files) == ["gt", "x", "z"]
        for key in theirs.files:
            assert ours[key].dtype == theirs[key].dtype and np.array_equal(ours[key], theirs[key])
        assert len(ours["gt"]) == 8
    benches = []
    real = tracker_benchmark.main

    def spy(argv=None):
        benches.append(argv)
        return real(argv)

    stages = ["--root", tmp_path / "port", *argv, "--bench-src", port_root,
              "--bench-videos", port_root / "videos", "--bench-limit", 1, "--epochs", 2,
              "--batch", 4, "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracker_benchmark, "main", spy)
        mp.setattr(siam_run, "siam_train_main",
                   functools.partial(siam_run.siam_train_main, holdout=2))
        run_quiet(siam_run.main, [str(a) for a in ["train", *stages]])
        run_quiet(siam_run.main, [str(a) for a in ["bench", *stages]])
    assert (tmp_path / "port" / "checkpoint" / "final.npz").is_file()
    assert len(benches) == 1 and benches[0][benches[0].index("--weights") + 1] == \
        str(tmp_path / "port" / "checkpoint" / "final.npz")
    rows = _results(tmp_path / "port" / "ope")
    assert set(rows) == {"detector_heuristic", "detector_tracker", "siamrpn_raw"}
    assert all(OPE_KEYS <= set(r) for r in rows.values())
