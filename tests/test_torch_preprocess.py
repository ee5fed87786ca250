"""The port's `preprocess` (`preprocess_main` and the CLI mode) against the JAX package's.

Neither side can decode video here (no cv2), so `read_video_frames` is
replaced in both modules by frames drawn from the fixture scenes, and the
videos are named by empty `.avi` files; `VIDEO_NUM_FRAMES` is patched to 6
as `tests/test_detector.py` does. Both run the TINY detector on the same
weights, carried from JAX's `PRNGKey(0)` init with the class logits' weights
scaled by 30, so that the untrained net keeps some detections at the 0.8
cut and not others. The pickles must match: same files, keys, lengths,
dtypes and labels, boxes within 0.25 px.
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import jax

from objectpermanence_tpu.infer import preprocess as jax_preprocess
from objectpermanence_tpu.models.detector import detector as jdet
from objectpermanence_tpu_torch.__main__ import main as port_main
from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
from objectpermanence_tpu_torch.infer import preprocess
from objectpermanence_tpu_torch.models.detector.convert import state_dict_from_jax
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_lane import one_torch_thread  # noqa: F401

FRAMES = 6
TINY = dict(image_hw=[120, 160], min_size=128, max_size=256, backbone_layers=[1, 1, 1, 1],
            backbone_width=16, fpn_channels=32, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=100,
            detections_per_img=20)
# video name -> (scene seed, frame count); the last has too few frames
VIDEOS = {"CATER_new_000001": (1, FRAMES), "CATER_new_000002": (2, FRAMES),
          "CATER_new_000003": (3, FRAMES - 1)}


def _frames(path):
    seed, count = VIDEOS[Path(path).stem]
    frames = draw_frames(make_scene(seed, num_frames=count), seed)
    return np.ascontiguousarray(frames[:, ::2, ::2])  # 120 x 160, TINY's frames


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg = jdet.DetectorConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in TINY.items()})
    params = jax.device_get(jdet.detector_init(jax.random.PRNGKey(0), cfg))
    cls = params["box_head"]["cls"]
    params["box_head"]["cls"] = {"w": cls["w"] * 30, "b": cls["b"]}
    path = save_params(tmp_path_factory.mktemp("w") / "detector.npz",
                       state_dict_from_jax(params, cfg.backbone_layers))
    return params, path


@pytest.fixture
def setup(tmp_path, monkeypatch, weights):
    params, npz = weights
    videos = tmp_path / "videos"
    videos.mkdir()
    for name in VIDEOS:
        (videos / f"{name}.avi").touch()
    for module in (preprocess, jax_preprocess):
        monkeypatch.setattr(module, "read_video_frames", _frames)
        monkeypatch.setattr(module, "VIDEO_NUM_FRAMES", FRAMES)
    monkeypatch.setattr(jdet.CaterDetector, "load", classmethod(
        lambda cls, path, config=None: cls(config, params=params)))
    config = {"videos_dir": str(videos), "batch_size": 4, "od_model_weights": str(npz),
              "device": "cpu", **TINY}
    return tmp_path, config


def _read(results):
    out = {}
    for path in sorted(Path(results).glob("*.pkl")):
        with open(path, "rb") as f:
            out[path.stem] = pickle.load(f)
    return out


def _assert_pickles_match(got, want):
    assert sorted(got) == sorted(want)
    kept = 0
    for name in want:
        g, w = got[name], want[name]
        assert set(g) == set(w) == {"bb", "labels"}
        assert len(g["bb"]) == len(w["bb"]) == len(g["labels"]) == FRAMES
        for gb, wb, gl, wl in zip(g["bb"], w["bb"], g["labels"], w["labels"]):
            assert gb.dtype == wb.dtype == np.float32 and gl.dtype == wl.dtype == np.int64
            assert gb.shape == wb.shape and gb.shape[1:] == (4,)
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_allclose(gb, wb, rtol=0, atol=0.25)
            kept += len(gb)
    return kept


def test_preprocess_main_matches_jax(setup):
    tmp_path, config = setup
    written = preprocess.preprocess_main(str(tmp_path / "port"), config)
    want_written = jax_preprocess.preprocess_main(str(tmp_path / "jax"), config)
    assert written == want_written == ["CATER_new_000001", "CATER_new_000002"]
    got, want = _read(tmp_path / "port"), _read(tmp_path / "jax")
    kept = _assert_pickles_match(got, want)
    total = sum(len(b) for data in got.values() for b in data["bb"])
    assert 0 < kept == total < 2 * FRAMES * TINY["detections_per_img"]


def test_cli_mode_writes_the_same_pickles(setup):
    tmp_path, config = setup
    (tmp_path / "config.json").write_text(json.dumps(config))
    rc = port_main(["preprocess", "--results_dir", str(tmp_path / "cli"),
                    "--config", str(tmp_path / "config.json")])
    assert rc == 0
    jax_preprocess.preprocess_main(str(tmp_path / "jax"), config)
    _assert_pickles_match(_read(tmp_path / "cli"), _read(tmp_path / "jax"))


def test_sample_file_restricts_the_videos(setup):
    tmp_path, config = setup
    (tmp_path / "sample.txt").write_text("CATER_new_000002.avi\nCATER_new_000003\n")
    config = {**config, "sample_file": str(tmp_path / "sample.txt")}
    assert preprocess.preprocess_main(str(tmp_path / "out"), config) == ["CATER_new_000002"]


def test_unknown_config_key_raises(setup):
    tmp_path, config = setup
    from objectpermanence_tpu_torch.config import ConfigError
    with pytest.raises(ConfigError, match="no_such_key"):
        preprocess.preprocess_main(str(tmp_path / "out"), {**config, "no_such_key": 1})


def test_detections_to_lists_schema():
    boxes = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    labels = np.array([[5, 6, 7], [8, 9, 10]], np.int32)
    scores = np.array([[0.9, 0.8, 0.5], [0.79, 0.95, -1e10]], np.float32)
    valid = scores > -1e9
    out = preprocess.detections_to_lists(boxes, labels, scores, valid)
    want = jax_preprocess.detections_to_lists(boxes, labels, scores, valid)
    for key in ("bb", "labels"):
        for g, w in zip(out[key], want[key]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert [len(b) for b in out["bb"]] == [2, 1]
