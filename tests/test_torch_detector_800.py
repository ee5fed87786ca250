"""The 800 px detector inference path against the JAX package's, on the CPU.

The configuration is the JAX package's 800 px recipe as
`scripts/detector_infer800.py` serves it (no geometry given: min 800 / max
1333, so 240 x 320 frames resize to 800 x 1067 and pad to 800 x 1088;
GroupNorm; `roi_backend="windowed"`), at TINY width (ResNet 1-1-1-1, width
16, FPN 32, RPN 200/100, 20 detections), in float32 and bfloat16. The JAX
detector runs its windowed kernel in interpret mode under `jax.jit`; its
weights come across by the weight bridge, with the class logits' weights
scaled 30x (as `tests/test_torch_preprocess.py` does) so that the untrained
net keeps detections above preprocess's 0.8 cut.

- RoIAlign of the pipeline (JAX's pyramid and proposals into the port's
  windowed backend): float32 within 1e-5 of the largest reference value;
  bfloat16 within 2e-2 (JAX's bf16 kernel rounds its interpolation weights
  to bf16, the port does not); the contract counts equal JAX's.
- End to end in float32: the detections preprocess keeps (score >= 0.8),
  frame by frame the same count and labels, boxes within 0.25 px. In bf16
  the scaled logits saturate to probability 1, so which of the tied
  detections are kept is decided by bf16 noise: bf16 is held stage by stage
  (`tests/test_torch_detector_bf16.py`) and here at the RoIAlign stage.
- The `preprocess` CLI on a fixture video in both dtypes: float32 pickles
  match JAX's detections, bf16 pickles the port's own detector.
- `evaluate_detector` at 800 px in both dtypes.
- `roi_path`, the port's copy of JAX's `_use_pallas_roi` with the card in
  the TPU's place.

The full-width end-to-end case (ResNet-50, one frame) takes about 35 s on
the CPU, JAX's init and compile included, more than the test lane affords
one case; the full width runs on the card (`chip_smoke.py`).
"""

import functools
import json
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import objectpermanence_tpu.ops.pallas_roi_align as pra
from objectpermanence_tpu.infer import preprocess as jax_preprocess
from objectpermanence_tpu.models.detector import detector as jdet
from objectpermanence_tpu_torch.__main__ import main as port_main
from objectpermanence_tpu_torch.config import preprocess_config_from
from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene, write_detection_fixture
from objectpermanence_tpu_torch.infer import preprocess
from objectpermanence_tpu_torch.models.detector import detector as det
from objectpermanence_tpu_torch.models.detector.convert import state_dict_from_jax
from objectpermanence_tpu_torch.ops import roi_align_window
from objectpermanence_tpu_torch.ops.roi_align_kernel import roi_align_windowed
from objectpermanence_tpu_torch.train.detector_loop import evaluate_detector

TINY_800 = dict(backbone_layers=(1, 1, 1, 1), backbone_width=16, fpn_channels=32,
                backbone_norm="group", rpn_pre_nms_top_n=200, rpn_post_nms_top_n=100,
                detections_per_img=20, roi_backend="windowed")
FRAMES = 4
SCORE_KEEP = 0.8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread: the lane's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames():
    return draw_frames(make_scene(6, num_frames=FRAMES), 6)


def _interpret(fn):
    orig = pra.pl.pallas_call
    pra.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        out = jax.device_get(fn())
        jax.effects_barrier()
        return out
    finally:
        pra.pl.pallas_call = orig


class Case:
    """JAX's 800 px pipeline on the fixture frames, in one dtype."""

    def __init__(self, dtype):
        kwargs = dict(TINY_800, compute_dtype=dtype)
        self.jcfg, self.cfg = jdet.DetectorConfig(**kwargs), det.DetectorConfig(**kwargs)
        assert self.cfg.padded_hw == (800, 1088)
        params = jax.device_get(jdet.detector_init(jax.random.PRNGKey(0), self.jcfg))
        cls = params["box_head"]["cls"]
        params["box_head"]["cls"] = {"w": cls["w"] * 30, "b": cls["b"]}
        self.params = params
        self.state = state_dict_from_jax(params, self.cfg.backbone_layers)
        self.frames = _frames()
        cfg = self.jcfg
        anchors = [jnp.asarray(a) for a in jdet.anchor_lib.pyramid_anchors(
            cfg.feature_shapes(), cfg.strides, cfg.anchor_sizes)]

        def pieces(p, images):
            pyramid = jdet.forward_features(p, jdet.preprocess_images(images, cfg), cfg)
            proposals, _ = jdet.propose(p, pyramid, cfg, anchors)
            pooled = jdet.batched_roi_align(pyramid[:4], proposals, cfg, layout="nhwc")
            return pyramid[:4], proposals, pooled, jdet.detect_forward(p, images, cfg, anchors)

        pra.reset_contract_stats()
        pyramid, self.proposals, self.pooled, self.outputs = _interpret(
            lambda: jax.jit(pieces)(params, jnp.asarray(self.frames)))
        # detect_forward's dispatch counted too: half of JAX's totals are the pooled stage's
        stats = pra.contract_stats()
        self.jax_stats = {k: v // 2 for k, v in stats.items()}
        pra.reset_contract_stats()
        self.pyramid = [np.array(p, np.float32).transpose(0, 3, 1, 2) for p in pyramid]


_CASES = {}


def _case(dtype):
    if dtype not in _CASES:
        _CASES[dtype] = Case(dtype)
    return _CASES[dtype]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def case(request):
    return _case(request.param)


def _close_to_max(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= rtol * scale, f"max abs err {err} > {rtol} x max |ref| {scale}"


def test_roi_align_of_the_800px_pipeline_matches_jax(case):
    dtype = getattr(torch, case.cfg.compute_dtype)
    pyramid = [torch.from_numpy(p).to(dtype) for p in case.pyramid]
    roi_align_window.reset_contract_stats()
    before = roi_align_windowed.launches
    with torch.inference_mode():
        got = det.batched_roi_align(pyramid, torch.from_numpy(np.array(case.proposals)),
                                    case.cfg)
    assert roi_align_windowed.launches == before  # the CPU runs the plain version
    assert got.dtype == dtype
    _close_to_max(got.float().numpy(), case.pooled,
                  1e-5 if case.cfg.compute_dtype == "float32" else 2e-2)
    assert roi_align_window.contract_stats() == case.jax_stats
    assert case.jax_stats["rois"] == FRAMES * case.cfg.rpn_post_nms_top_n
    roi_align_window.reset_contract_stats()


def _kept(boxes, labels, scores, valid, f):
    keep = valid[f] & (scores[f] >= SCORE_KEEP)
    return boxes[f][keep], labels[f][keep]


def test_detections_match_jax_end_to_end_in_float32():
    case = _case("float32")
    detector = det.CaterDetector(case.cfg, state_dict=case.state, device="cpu")
    outputs = detector(case.frames)
    kept = 0
    for f in range(FRAMES):
        boxes, labels = _kept(*outputs, f)
        want_boxes, want_labels = _kept(*case.outputs, f)
        np.testing.assert_array_equal(labels, want_labels)
        np.testing.assert_allclose(boxes, want_boxes, rtol=0, atol=0.25)
        kept += len(labels)
    assert kept > 0
    roi_align_window.reset_contract_stats()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocess_cli_runs_the_800px_recipe(dtype, tmp_path, monkeypatch):
    """No geometry in the config: the 800 px defaults, as in JAX."""
    case = _case(dtype)
    videos = tmp_path / "videos"
    videos.mkdir()
    (videos / "CATER_new_000001.avi").touch()
    monkeypatch.setattr(preprocess, "read_video_frames", lambda path: case.frames)
    monkeypatch.setattr(preprocess, "VIDEO_NUM_FRAMES", FRAMES)
    weights = tmp_path / "detector.npz"
    from objectpermanence_tpu_torch.utils.checkpoint import save_params
    save_params(weights, case.state)
    config = {**{k: list(v) if isinstance(v, tuple) else v for k, v in TINY_800.items()},
              "compute_dtype": dtype, "videos_dir": str(videos), "batch_size": 3,
              "od_model_weights": str(weights), "device": "cpu"}
    _, overrides = preprocess_config_from(config)
    assert det.DetectorConfig(**overrides) == case.cfg
    (tmp_path / "preprocess.json").write_text(json.dumps(config))
    assert port_main(["preprocess", "--results_dir", str(tmp_path / "out"),
                      "--config", str(tmp_path / "preprocess.json")]) == 0
    with open(tmp_path / "out" / "CATER_new_000001.pkl", "rb") as f:
        got = pickle.load(f)
    if dtype == "float32":
        want = jax_preprocess.detections_to_lists(*[np.asarray(o) for o in case.outputs])
    else:
        detector = det.CaterDetector(case.cfg, state_dict=case.state, device="cpu")
        want = preprocess.detections_to_lists(*detector(case.frames))
    assert len(got["bb"]) == len(want["bb"]) == FRAMES
    for gb, wb, gl, wl in zip(got["bb"], want["bb"], got["labels"], want["labels"]):
        assert gb.dtype == np.float32 and gl.dtype == np.int64
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=0.25 if dtype == "float32" else 0)
    assert sum(len(b) for b in got["bb"]) > 0
    roi_align_window.reset_contract_stats()


def test_evaluate_detector_at_800px_in_both_dtypes(tmp_path):
    """The fixture's frames relabelled with the float32 detector's three
    best detections each (as `tests/test_torch_detector_loop.py` does): the
    float32 detector finds them, and the bf16 one gives a valid score."""
    case = _case("float32")
    images_dir, _, frames = write_detection_fixture(tmp_path / "det", 2, 2, seed=4)
    names = sorted(frames)
    detectors = {dtype: det.CaterDetector(det.DetectorConfig(**TINY_800, compute_dtype=dtype),
                                          state_dict=case.state, device="cpu")
                 for dtype in ("float32", "bfloat16")}
    rows = ["filename,object_class,X,Y,width,height"]
    for name in names:
        boxes, labels, _, valid = detectors["float32"](frames[name][None])
        for box, label in list(zip(boxes[0][valid[0]], labels[0][valid[0]]))[:3]:
            rows.append(f"{name},{label},{box[0]:.2f},{box[1]:.2f},{box[2] - box[0]:.2f},"
                        f"{box[3] - box[1]:.2f}")
    (tmp_path / "relabelled.csv").write_text("\n".join(rows) + "\n")
    data = DetectionDataset(images_dir, tmp_path / "relabelled.csv")
    data.load_image = frames.__getitem__
    metrics = {dtype: evaluate_detector(d, data, batch_size=3) for dtype, d in detectors.items()}
    assert metrics["float32"]["AP50"] > 0.5
    for values in metrics.values():
        assert set(values) == {"mAP", "AP50", "AP75"}
        assert all(0.0 <= v <= 1.0 for v in values.values())
    roi_align_window.reset_contract_stats()


@pytest.mark.parametrize("needs_grad", [False, True])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("config", [
    {},                                                   # 800 px, C=256
    {"min_size": 240, "max_size": 320},                   # the native pyramid: 7 MB
    {"fpn_channels": 32},                                 # not a multiple of 128
    {"roi_backend": "windowed"}, {"roi_backend": "pallas"}, {"roi_backend": "gather"}])
def test_roi_path_is_jax_dispatch_with_the_card_as_the_tpu(config, device, needs_grad,
                                                           monkeypatch):
    monkeypatch.setattr(jdet.jax, "default_backend", lambda: "tpu" if device == "cuda" else "cpu")
    want = jdet._use_pallas_roi(jdet.DetectorConfig(**config), needs_grad=needs_grad)
    got = det.roi_path(det.DetectorConfig(**config), torch.device(device), needs_grad)
    assert got == ("windowed" if want == "windowed" else "exact")


def test_default_config_is_the_800px_geometry():
    cfg = det.DetectorConfig()
    assert (cfg.min_size, cfg.max_size, cfg.padded_hw) == (800, 1333, (800, 1088))
    assert cfg.feature_shapes()[:4] == [(200, 272), (100, 136), (50, 68), (25, 34)]
    _, overrides = preprocess_config_from({"videos_dir": "v"})
    assert overrides == {}
    assert det.roi_path(cfg, torch.device("cuda"), needs_grad=False) == "windowed"
