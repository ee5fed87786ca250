"""The port's `experiments/two_stage_run.py` against the JAX package's
`scripts/two_stage_run.py` (imported as `scripts.two_stage_run`) on the CPU.

Both drivers run on the same seeded scenes, each on its own root. The
detector is `tests/test_two_stage_driver.py`'s TINY (60 x 80 input, depth-1
GroupNorm backbone, width 16, FPN 32); OPNet is narrow (hidden 16/24), the
port's built from JAX's init. Tolerances, with their reasons:
- `render`: every file byte for byte (the renderer and cv2's MJPG writer
  are deterministic);
- `dettrain`: from the same init on the same draws (`torch_experiment_
  helpers.same_detector_start`), each step's four loss parts and their sum
  within 1e-5 relative (`tests/test_torch_detector_train.py`'s TINY step);
  `report.json` with JAX's keys and history, and its test mAP, AP50 and
  AP75 within 1e-6 of JAX's;
- `preprocess` on the same weights (JAX's init with the class logits'
  weights scaled by 30, so that the untrained net keeps some detections at
  the 0.8 cut, as `tests/test_torch_preprocess.py` does), over the first 50
  frames of each video: the same pickles, labels equal, boxes within 0.25
  px, and `perception_stats.json` equal; on at most 2% of the frames a
  detection whose score lies within 1e-4 of the 0.8 cut falls on the other
  side of it, or two whose scores lie within rounding of each other come in
  the other order, and such a frame's detections are paired off by label
  and box, the leftovers checked against the port's scores. Its detector
  is TINY with RPN top-n 40/20 in place of 100/60: the class NMS over
  proposals x 192 classes is dense and takes most of the CPU time;
- `opnet` on the same detections (each split's perfect-perception pickles
  as its `od_real`, 8 train and 2 dev videos: JAX's eval batch is rounded up
  to the 8-device CPU mesh, and so is the padding its eval loss averages
  over): losses rtol 1e-4 and mean IoUs atol 1e-3, the same "Saved best
  model" lines (`tests/test_torch_experiments.py`'s); `train_meta.json`
  equal but for its time;
- `analyze` on JAX's trained weights: the boxes equal, each CSV column
  within 1e-6.
"""

import json
import pickle

import jax
import numpy as np
import pandas as pd
import pytest

import scripts.two_stage_run as jax_ts
from objectpermanence_tpu.infer import preprocess as jax_preprocess
from objectpermanence_tpu.models.detector import detector as jdet
from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
from objectpermanence_tpu.utils.checkpoint import best_params_checkpoint as jax_best
from objectpermanence_tpu.utils.checkpoint import restore_params
from objectpermanence_tpu_torch.experiments import containment_run, two_stage_run
from objectpermanence_tpu_torch.infer import preprocess as port_preprocess
from objectpermanence_tpu_torch.infer.preprocess import detections_to_lists
from objectpermanence_tpu_torch.models.convert import params_from_jax
from objectpermanence_tpu_torch.models.detector.convert import state_dict_from_jax
from objectpermanence_tpu_torch.models.detector.detector import DetectorConfig
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_experiment_helpers import (
    files, from_jax_init, jax_config, jax_init, run_quiet, same_detector_start,
)
from torch_lane import one_torch_thread  # noqa: F401

TINY = dict(min_size=60, max_size=80, backbone_layers=(1, 1, 1, 1), backbone_width=16,
            fpn_channels=32, rpn_pre_nms_top_n=100, rpn_post_nms_top_n=60,
            detections_per_img=16, backbone_norm="group")
TINY_PREPROCESS = {**TINY, "rpn_pre_nms_top_n": 40, "rpn_post_nms_top_n": 20}
NARROW = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
          "videos_hidden_dim": 24}
FRAMES, OBJECTS = 300, 4
PIXELS = {"train": (2, 41), "dev": (1, 42), "test": (1, 43)}       # split: scenes, seed
REASONING = {"train": (8, 51), "dev": (2, 52), "test": (2, 53)}
DET_BATCH, DET_SAMPLES, EPOCHS = 2, 2, 2
LOSS_RTOL, MAP_ATOL, BOX_PX, SCORE_EPS, DIFFER_SHARE = 1e-5, 1e-6, 0.25, 1e-4, 2e-2
PREPROCESS_FRAMES = 50


def _source(base, splits):
    for split, (scenes, seed) in splits.items():
        run_quiet(containment_run.gen_split, base, split, scenes, seed, FRAMES, OBJECTS)
    return base


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """`render` of both over the same scenes."""
    src = _source(tmp_path_factory.mktemp("pixels_src"), PIXELS)
    base = tmp_path_factory.mktemp("twostage")
    run_quiet(jax_ts.render, src, base / "jax", DET_SAMPLES)
    run_quiet(two_stage_run.render, src, base / "port", DET_SAMPLES)
    return src, base / "jax", base / "port"


def _configs(mp, jax_cfg, port_cfg):
    mp.setattr(jax_ts, "detector_config", lambda: jax_cfg)
    mp.setattr(two_stage_run, "detector_config", lambda: port_cfg)


@pytest.fixture(scope="module")
def dettrained(rendered):
    """`dettrain` of both, 1 epoch, from the same start."""
    _, jax_root, port_root = rendered
    steps = PIXELS["train"][0] * DET_SAMPLES // DET_BATCH
    with pytest.MonkeyPatch.context() as mp:
        _configs(mp, jax_config(**TINY), DetectorConfig(**TINY))
        losses = same_detector_start(mp, jax_config(**TINY), steps)
        run_quiet(jax_ts.dettrain, jax_root, 1, DET_BATCH, 5e-3)
        run_quiet(two_stage_run.dettrain, port_root, 1, DET_BATCH, 5e-3, device="cpu")
    return losses, steps


def test_render_bytes_equal(rendered):
    _, jax_root, port_root = rendered
    ours, theirs = files(port_root), files(jax_root)
    assert sorted(ours) == sorted(theirs)
    for split, (scenes, _) in PIXELS.items():
        assert len([k for k in ours if k.startswith(f"{split}/videos/")]) == scenes
        assert len([k for k in ours if k.endswith(".png") and k.startswith(split)]) == \
            scenes * DET_SAMPLES
    for key in theirs:
        assert ours[key] == theirs[key], key


def test_dettrain_matches_jax(rendered, dettrained):
    _, jax_root, port_root = rendered
    losses, steps = dettrained
    assert len(losses["port"]) == len(losses["jax"]) == steps
    for ours, theirs in zip(losses["port"], losses["jax"]):
        assert set(ours) == set(theirs)
        for name in theirs:
            assert ours[name] == pytest.approx(theirs[name], rel=LOSS_RTOL), name
    ours = json.loads((port_root / "detector" / "report.json").read_text())
    theirs = json.loads((jax_root / "detector" / "report.json").read_text())
    assert set(ours) == set(theirs) == {"best_dev_map", "test", "history", "checkpoint"}
    assert (port_root / "detector" / ".done").exists()
    assert ours["checkpoint"].endswith(".npz") and ours["checkpoint"].startswith(
        str(port_root / "detector" / "best_"))
    assert [h["epoch"] for h in ours["history"]] == [h["epoch"] for h in theirs["history"]]
    assert set(theirs["history"][0]) <= set(ours["history"][0])
    assert ours["history"][0]["train_loss"] == pytest.approx(theirs["history"][0]["train_loss"],
                                                             rel=LOSS_RTOL)
    assert set(ours["test"]) == set(theirs["test"]) == {"mAP", "AP50", "AP75"}
    for key in theirs["test"]:
        assert ours["test"][key] == pytest.approx(theirs["test"][key], abs=MAP_ATOL), key
    # a second call finds the marker
    assert "already complete" in run_quiet(two_stage_run.dettrain, port_root, 1, DET_BATCH, 5e-3,
                                           device="cpu")


def _read(root, split):
    out = {}
    for path in sorted((root / split / "od_real").glob("*.pkl")):
        with open(path, "rb") as f:
            out[path.stem] = pickle.load(f)
    return out


def _matched(gb, gl, wb, wl, raw):
    """Whether the detections of one frame pair off, each with one of the
    other side's of the same label and a box within BOX_PX, but for those
    whose score lies within SCORE_EPS of the 0.8 cut (the port's `raw`
    boxes, labels and scores of the frame), which may fall on either side
    of it. Two detections whose scores lie within rounding of each other
    keep score order on each side, which may differ."""
    free = list(range(len(wl)))
    leftovers = []
    for box, label in zip(gb, gl):
        hits = [j for j in free if wl[j] == label and np.abs(wb[j] - box).max() <= BOX_PX]
        if hits:
            free.remove(hits[0])
        else:
            leftovers.append((box, label))
    leftovers += [(wb[j], wl[j]) for j in free]
    boxes, labels, scores = raw
    for box, label in leftovers:
        near = (labels == label) & (np.abs(boxes - box).max(axis=1) <= BOX_PX)
        if not (near & (np.abs(scores - 0.8) <= SCORE_EPS)).any():
            return False
    return True


def test_preprocess_matches_jax(rendered, tmp_path):
    """`preprocess` of both on the same weights over the first PREPROCESS_FRAMES
    frames of each video (`VIDEO_NUM_FRAMES` patched, as
    `tests/test_torch_preprocess.py` does); JAX's slices run in this process
    (its `preprocess-worker` stage's function), as the port's split does."""
    _, jax_rendered, _ = rendered
    jax_cfg = jax_config(**TINY_PREPROCESS)
    params, _ = jax_init(jax_cfg)
    cls = params["box_head"]["cls"]
    params["box_head"]["cls"] = {"w": cls["w"] * 30, "b": cls["b"]}
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for root in (jax_root, port_root):
        for split in PIXELS:
            (root / split).mkdir(parents=True)
            (root / split / "videos").symlink_to(jax_rendered / split / "videos")
    save_params(port_root / "detector" / "best_0.5.npz",
                state_dict_from_jax(params, jax_cfg.backbone_layers))
    raw = []

    def spy(boxes, labels, scores, valid):
        raw.append([(b[v], l[v], s[v]) for b, l, s, v in zip(boxes, labels, scores, valid)])
        return detections_to_lists(boxes, labels, scores, valid)

    with pytest.MonkeyPatch.context() as mp:
        _configs(mp, jax_cfg, DetectorConfig(**TINY_PREPROCESS))
        for module in (port_preprocess, jax_preprocess):
            decode = module.read_video_frames
            mp.setattr(module, "read_video_frames",
                       lambda path, decode=decode: decode(path)[:PREPROCESS_FRAMES])
            mp.setattr(module, "VIDEO_NUM_FRAMES", PREPROCESS_FRAMES)
        mp.setattr(port_preprocess, "detections_to_lists", spy)
        # one JAX detector for every slice: its forward compiles once
        jax_detector = jdet.CaterDetector(jax_cfg, params=params)
        mp.setattr(jdet.CaterDetector, "load", classmethod(
            lambda cls, path, config=None: jax_detector))
        for split in PIXELS:
            names = sorted(p.name for p in (jax_root / split / "videos").glob("*.avi"))
            (jax_root / split / "preprocess_todo.txt").write_text(
                "".join(n + "\n" for n in names))
            run_quiet(jax_ts._preprocess_split_worker, jax_root, split, 16)
        run_quiet(jax_ts.preprocess, jax_root, 16)   # finds every split complete
        out = run_quiet(two_stage_run.preprocess, port_root, 16, device="cpu")
        # a rerun finds every split complete and runs no worker
        mp.setattr(two_stage_run, "_preprocess_split_worker",
                   lambda *args, **kwargs: pytest.fail("a complete split ran again"))
        again = run_quiet(two_stage_run.preprocess, port_root, 16, device="cpu")
    assert "[preprocess] train: 2/2 videos detected" in out
    assert "[preprocess] train: 2/2 videos detected" in again
    kept = differ = 0
    port_raw = iter(raw)    # the port's videos in the order it ran them
    for split, (scenes, _) in PIXELS.items():
        ours, theirs = _read(port_root, split), _read(jax_root, split)
        assert sorted(ours) == sorted(theirs) and len(ours) == scenes
        for name in sorted(theirs):
            got, want, frames_raw = ours[name], theirs[name], next(port_raw)
            assert set(got) == set(want) == {"bb", "labels"}
            assert len(got["bb"]) == len(want["bb"]) == len(got["labels"]) == PREPROCESS_FRAMES
            for gb, wb, gl, wl, fr in zip(got["bb"], want["bb"], got["labels"], want["labels"],
                                          frames_raw):
                assert gb.dtype == wb.dtype == np.float32 and gl.dtype == wl.dtype == np.int64
                assert gb.shape[1:] == wb.shape[1:] == (4,)
                if not (np.array_equal(gl, wl) and np.abs(gb - wb).max(initial=0) <= BOX_PX):
                    differ += 1
                    assert _matched(gb, gl, wb, wl, fr), (name, gl, wl)
                kept += len(gb)
    assert kept > 0 and differ <= DIFFER_SHARE * PREPROCESS_FRAMES * len(raw)
    assert json.loads((port_root / "perception_stats.json").read_text()) == \
        json.loads((jax_root / "perception_stats.json").read_text())


@pytest.fixture(scope="module")
def reasoning(tmp_path_factory):
    """`opnet` of both, EPOCHS epochs, on each split's perfect-perception
    pickles as its detections."""
    src = _source(tmp_path_factory.mktemp("reasoning_src"), REASONING)
    base = tmp_path_factory.mktemp("reasoning")
    for root in (base / "jax", base / "port"):
        for split in REASONING:
            (root / split).mkdir(parents=True)
            (root / split / "od_real").symlink_to(src / split / "od_perception")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ts, "load_model_config", lambda name: dict(NARROW))
        mp.setattr(two_stage_run, "load_model_config", lambda name: dict(NARROW))
        mp.setattr(two_stage_run, "get_model_spec",
                   from_jax_init(two_stage_run.get_model_spec, NARROW))
        jax_out = run_quiet(jax_ts.opnet, base / "jax", src, EPOCHS, False)
        port_out = run_quiet(two_stage_run.opnet, base / "port", src, EPOCHS, False,
                             device="cpu")
    return src, base / "jax", base / "port", jax_out, port_out


def _metrics(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _saved(text):
    return [line for line in text.splitlines() if line.startswith("Saved best model")]


def test_opnet_matches_jax(reasoning):
    _, jax_root, port_root, jax_out, port_out = reasoning
    ours, theirs = _metrics(port_root / "metrics.jsonl"), _metrics(jax_root / "metrics.jsonl")
    assert [e["epoch"] for e in ours] == [e["epoch"] for e in theirs] == [1, 2]
    for a, b in zip(ours, theirs):
        assert a["learning_rate"] == pytest.approx(b["learning_rate"], rel=1e-6)
        for split in ("train", "dev"):
            np.testing.assert_allclose(a[split]["loss"], b[split]["loss"], rtol=1e-4)
            for key in ("mean_iou", "containment_mean_iou"):
                np.testing.assert_allclose(a[split][key], b[split][key], atol=1e-3)
    assert _saved(port_out) == _saved(jax_out) and _saved(port_out)
    meta = [json.loads((root / "train_meta.json").read_text()) for root in (port_root, jax_root)]
    for m in meta:
        m.pop("completed_unix")
    assert meta[0] == meta[1] and meta[0]["train_videos"] == REASONING["train"][0]


def test_analyze_matches_jax(reasoning, tmp_path):
    """`analyze` of both on JAX's trained weights (the port's as an npz)."""
    src, jax_root, port_root, _, _ = reasoning
    (tmp_path / "test").symlink_to(port_root / "test")
    leaf = jax_best(jax_root / "checkpoints" / "opnet")
    like = jax_get_model_spec("opnet", NARROW).init(jax.random.PRNGKey(0), NARROW)
    save_params(tmp_path / "checkpoints" / "opnet" / f"{leaf.name}.npz",
                params_from_jax(jax.device_get(restore_params(leaf, like))))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ts, "load_model_config", lambda name: dict(NARROW))
        mp.setattr(two_stage_run, "load_model_config", lambda name: dict(NARROW))
        run_quiet(jax_ts.analyze, jax_root, src)
        run_quiet(two_stage_run.analyze, tmp_path, src, device="cpu")
    boxes = files(tmp_path / "results")
    assert len(boxes) == REASONING["test"][0] and boxes == files(jax_root / "results")
    ours = pd.read_csv(tmp_path / "analysis.csv")
    theirs = pd.read_csv(jax_root / "analysis.csv")
    assert list(ours.columns) == list(theirs.columns) and len(ours) == REASONING["test"][0]
    assert list(ours["videos_names"]) == list(theirs["videos_names"])
    for column in theirs.columns[1:]:
        np.testing.assert_allclose(ours[column].to_numpy(float), theirs[column].to_numpy(float),
                                   rtol=0, atol=1e-6, err_msg=column)
    with pytest.raises(FileNotFoundError, match="no trained baseline_lstm checkpoint"):
        two_stage_run.analyze(tmp_path, src, "baseline_lstm", device="cpu")
