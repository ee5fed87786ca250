"""The port's Faster R-CNN against the JAX package's, on the CPU, at two
widths: TINY (`tests/test_detector.py`'s reduced config, frames 120 x 160
upscaled to 128 x 171) and FULL, the shipped preprocess config
(`configs/preprocess_config.json`: ResNet-50 FPN 256, 193 classes, native
240 x 320 frames padded to 256 x 320, RPN 500/300), on two frames drawn
from the fixture scenes.

The JAX detector is initialised from `PRNGKey(0)` and its weights are
carried across by the weight bridge, so both sides hold the same numbers.

- (a) The bridge is exact: the port's state_dict equals JAX's
  `export_torchvision_state_dict` key for key and bit for bit, and a
  `.pth` round trip gives identical detections.
- (b) Stage by stage, each stage fed JAX's own inputs. Frozen BN with
  identity statistics normalises nothing, so the pyramid's values reach
  about 1e3: dense tensors are held within 1e-5 of the largest reference
  value of their level. Proposal and detection sets must be identical,
  boxes within 1e-4 px.
- (c) End to end, the detections kept by preprocess (score >= 0.8) agree
  frame by frame in count and labels, boxes within 0.25 px.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from objectpermanence_tpu.models.detector import detector as jdet
from objectpermanence_tpu.models.detector import roi_heads as jroi
from objectpermanence_tpu.models.detector import rpn as jrpn
from objectpermanence_tpu.models.detector.convert import export_torchvision_state_dict
from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
from objectpermanence_tpu_torch.models.detector import detector as det
from objectpermanence_tpu_torch.models.detector.convert import (
    state_dict_from_jax, torchvision_state_dict,
)
from objectpermanence_tpu_torch.models.detector.roi_heads import postprocess_detections
from objectpermanence_tpu_torch.models.detector.rpn import generate_proposals
from objectpermanence_tpu_torch.ops.nms import NEG_INF
from torch_lane import one_torch_thread  # noqa: F401

SCORE_KEEP = 0.8  # preprocess's cut
CONFIGS = {
    "tiny": dict(image_hw=(120, 160), min_size=128, max_size=256, backbone_layers=(1, 1, 1, 1),
                 backbone_width=16, fpn_channels=32, rpn_pre_nms_top_n=200,
                 rpn_post_nms_top_n=100, detections_per_img=20),
    "full": dict(min_size=240, max_size=320, rpn_pre_nms_top_n=500, rpn_post_nms_top_n=300),
}


def _frames(hw):
    frames = np.concatenate([draw_frames(make_scene(seed, num_frames=40), seed)[[8]]
                             for seed in (3, 4)])
    if hw != frames.shape[1:3]:  # TINY's smaller frames: every second pixel
        frames = np.ascontiguousarray(frames[:, ::2, ::2])
    return frames


class Case:
    """One config: JAX params and forward pieces, the port's detector on the
    same weights, and the frames."""

    def __init__(self, name):
        kwargs = CONFIGS[name]
        self.jcfg = jdet.DetectorConfig(**kwargs)
        self.cfg = det.DetectorConfig(**kwargs)
        self.params = jax.device_get(jdet.detector_init(jax.random.PRNGKey(0), self.jcfg))
        self.layers = self.cfg.backbone_layers
        self.state = state_dict_from_jax(self.params, self.layers)
        self.detector = det.CaterDetector(self.cfg, state_dict=self.state, device="cpu")
        self.model = self.detector.model
        self.janchors = [jnp.asarray(a) for a in jdet.anchor_lib.pyramid_anchors(
            self.jcfg.feature_shapes(), self.jcfg.strides, self.jcfg.anchor_sizes)]
        self.frames = _frames(self.cfg.image_hw)
        self._jax = {}

    def jax(self, key):
        """JAX's intermediate results, computed once."""
        if not self._jax:
            p, cfg = self.params, self.jcfg
            prepped = jdet.preprocess_images(jnp.asarray(self.frames), cfg)
            pyramid = jax.jit(lambda p, x: jdet.forward_features(p, x, cfg))(p, prepped)
            objectness, deltas = jax.jit(jrpn.rpn_head_apply)(p["rpn"], pyramid)
            sig = [jax.nn.sigmoid(o) for o in objectness]
            proposals, prop_scores = jax.jit(
                lambda s, d: jrpn.generate_proposals(
                    s, d, self.janchors, cfg.padded_hw, cfg.rpn_pre_nms_top_n,
                    cfg.rpn_post_nms_top_n, cfg.rpn_nms_thresh))(sig, deltas)
            pooled = jdet.batched_roi_align([q.transpose(0, 3, 1, 2) for q in pyramid[:4]],
                                            proposals, cfg)
            logits, box_deltas = jax.jit(jax.vmap(jroi.box_head_apply, (None, 0)))(
                p["box_head"], pooled)
            post = jax.jit(jax.vmap(lambda lg, bd, pr, ps: jroi.postprocess_detections(
                lg, bd, pr, ps, cfg.padded_hw, cfg.score_thresh, cfg.nms_thresh,
                cfg.detections_per_img)))(logits, box_deltas, proposals, prop_scores)
            outputs = jax.jit(lambda p, x: jdet.detect_forward(p, x, cfg, self.janchors))(
                p, jnp.asarray(self.frames))
            self._jax = jax.device_get({
                "prepped": prepped, "pyramid": pyramid, "objectness": objectness,
                "sigmoid": sig, "deltas": deltas, "proposals": proposals,
                "prop_scores": prop_scores, "pooled": pooled, "logits": logits,
                "box_deltas": box_deltas, "post": post, "outputs": outputs})
        return self._jax[key]


_CASES = {}


def _case(name):
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    return _case(request.param)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


def _close_to_max(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max abs err {err} > {rtol} x max |ref| {scale}"


# (a) the weight bridge


def test_bridge_is_exact(case):
    want = export_torchvision_state_dict(case.params, case.layers)
    assert list(case.state) == list(want)
    model_state = case.model.state_dict()
    assert set(model_state) == set(want)
    for key, value in want.items():
        assert case.state[key].dtype == torch.float32
        np.testing.assert_array_equal(case.state[key].numpy(), value, err_msg=key)
        np.testing.assert_array_equal(model_state[key].numpy(), value, err_msg=key)


def test_pth_round_trip_gives_identical_detections(tmp_path):
    case = _case("tiny")
    want = case.detector(case.frames)
    # the reference's wrapper, torchvision's newer nested FPN/RPN names and
    # its BN counters: all must load into the same weights
    nested = {}
    for key, value in case.state.items():
        key = key.replace("rpn.head.conv.", "rpn.head.conv.0.0.")
        for block in ("inner_blocks", "layer_blocks"):
            for i in range(4):
                key = key.replace(f"fpn.{block}.{i}.", f"fpn.{block}.{i}.0.")
        nested[key] = value
    nested["backbone.body.bn1.num_batches_tracked"] = torch.tensor(0)
    for name, blob in (("flat.pth", dict(case.state)),
                       ("wrapped.pth", {"model_state_dict": nested})):
        torch.save(blob, tmp_path / name)
        loaded = det.CaterDetector.load(str(tmp_path / name), case.cfg, device="cpu")
        for got, exp in zip(loaded(case.frames), want):
            np.testing.assert_array_equal(got, exp)
    assert set(torchvision_state_dict({"model_state_dict": nested})) == set(case.state)


def test_npz_round_trip(tmp_path):
    from objectpermanence_tpu_torch.utils.checkpoint import save_params
    case = _case("tiny")
    path = save_params(tmp_path / "detector.npz", case.model.state_dict())
    loaded = det.CaterDetector.load(str(path), case.cfg, device="cpu")
    for got, exp in zip(loaded(case.frames), case.detector(case.frames)):
        np.testing.assert_array_equal(got, exp)


# (b) stage by stage


def test_preprocess_images_matches(case):
    got = det.preprocess_images(_t(case.frames), case.cfg)
    want = case.jax("prepped")
    assert tuple(got.shape[-2:]) == case.cfg.padded_hw
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("min_size", [100, 400])
def test_resize_matches_jax_when_shrinking_and_enlarging(min_size):
    frames = np.random.RandomState(min_size).randint(0, 256, (2, 240, 320, 3)).astype(np.uint8)
    kwargs = dict(min_size=min_size, max_size=2000)
    got = det.preprocess_images(_t(frames), det.DetectorConfig(**kwargs)).numpy()
    want = np.asarray(jdet.preprocess_images(jnp.asarray(frames), jdet.DetectorConfig(**kwargs)))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=0, atol=1e-4)


def test_pyramid_matches(case):
    with torch.inference_mode():
        got = det.forward_features(case.model, _nchw(case.jax("prepped")))
    want = case.jax("pyramid")
    assert len(got) == 5
    for level, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape[-2:]) == case.cfg.feature_shapes()[level]
        _close_to_max(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2))


def test_rpn_head_matches(case):
    with torch.inference_mode():
        objectness, deltas = case.model.rpn.head([_nchw(p) for p in case.jax("pyramid")])
    for g, w in zip(objectness, case.jax("objectness")):
        _close_to_max(g.numpy(), w)
    for g, w in zip(deltas, case.jax("deltas")):
        _close_to_max(g.numpy(), w)


def test_generate_proposals_identical(case):
    cfg = case.cfg
    proposals, scores = generate_proposals(
        [_t(s) for s in case.jax("sigmoid")], [_t(d) for d in case.jax("deltas")],
        case.detector.anchors, cfg.padded_hw, cfg.rpn_pre_nms_top_n, cfg.rpn_post_nms_top_n,
        cfg.rpn_nms_thresh)
    want_props, want_scores = case.jax("proposals"), case.jax("prop_scores")
    assert proposals.shape == want_props.shape
    np.testing.assert_array_equal(scores.numpy(), want_scores)  # same kept set, same order
    valid = want_scores > NEG_INF / 10
    assert valid.sum() > 0
    np.testing.assert_allclose(proposals.numpy()[valid], want_props[valid], rtol=0, atol=1e-4)


def test_box_head_matches(case):
    with torch.inference_mode():
        logits, deltas = case.model.roi_heads(_t(case.jax("pooled")))
    _close_to_max(logits.numpy(), case.jax("logits"))
    _close_to_max(deltas.numpy(), case.jax("box_deltas"))


def test_postprocess_identical(case):
    cfg = case.cfg
    boxes, labels, scores = postprocess_detections(
        _t(case.jax("logits")), _t(case.jax("box_deltas")), _t(case.jax("proposals")),
        _t(case.jax("prop_scores")), cfg.padded_hw, cfg.score_thresh, cfg.nms_thresh,
        cfg.detections_per_img)
    want_boxes, want_labels, want_scores = case.jax("post")
    valid = want_scores > NEG_INF / 10
    np.testing.assert_array_equal(scores.numpy() > NEG_INF / 10, valid)
    np.testing.assert_array_equal(labels.numpy()[valid], want_labels[valid])
    np.testing.assert_allclose(scores.numpy()[valid], want_scores[valid], rtol=1e-6, atol=0)
    np.testing.assert_allclose(boxes.numpy()[valid], want_boxes[valid], rtol=0, atol=1e-4)


def test_roi_align_of_the_pipeline_matches(case):
    from objectpermanence_tpu_torch.ops.roi_align_kernel import roi_align_batched
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES, assign_levels
    proposals = _t(case.jax("proposals"))
    pyramid = [_nchw(p) for p in case.jax("pyramid")[:4]]
    got = roi_align_batched(pyramid, proposals, assign_levels(proposals), ROI_STRIDES)
    _close_to_max(got.numpy(), case.jax("pooled"))


# (c) end to end


def _assert_kept_detections_match(outputs, want_outputs):
    """The detections preprocess keeps (score >= 0.8): per frame the same
    count and labels, boxes within 0.25 px. Returns how many were kept."""
    boxes, labels, scores, valid = outputs
    want_boxes, want_labels, want_scores, want_valid = want_outputs
    assert boxes.shape == want_boxes.shape
    kept_total = 0
    for f in range(len(boxes)):
        keep = valid[f] & (scores[f] >= SCORE_KEEP)
        want_keep = want_valid[f] & (want_scores[f] >= SCORE_KEEP)
        near = np.abs(want_scores[f][want_valid[f]] - SCORE_KEEP)
        assert keep.sum() == want_keep.sum(), \
            f"frame {f}: {keep.sum()} vs {want_keep.sum()} kept; closest score to the cut " \
            f"is {near.min() if near.size else None} away"
        np.testing.assert_array_equal(labels[f][keep], want_labels[f][want_keep])
        np.testing.assert_allclose(boxes[f][keep], want_boxes[f][want_keep], rtol=0, atol=0.25)
        kept_total += int(keep.sum())
    return kept_total


def test_detections_kept_by_preprocess_match_end_to_end(case):
    kept = _assert_kept_detections_match(case.detector(case.frames), case.jax("outputs"))
    if case.cfg.fpn_channels == 256:  # the untrained full-width detector does detect
        assert kept > 0


def test_detect_video_in_chunks_matches_end_to_end(case):
    chunked = case.detector.detect_video(case.frames, batch_size=1)
    _assert_kept_detections_match(chunked, case.jax("outputs"))


@pytest.mark.parametrize("options", [{"compute_dtype": "bfloat16"}, {"roi_backend": "windowed"},
                                     {"compute_dtype": "bfloat16", "roi_backend": "windowed"}])
def test_bf16_and_windowed_options_detect(options):
    """Both options build a detector and detect; TINY's pyramid lies inside
    the windowed RoIAlign's window (56 px at C=32), so in float32 it drops no
    tap and detects exactly what the exact backend does."""
    from objectpermanence_tpu_torch.ops import roi_align_window
    case = _case("tiny")
    detector = det.CaterDetector(det.DetectorConfig(**CONFIGS["tiny"], **options),
                                 state_dict=case.state, device="cpu")
    roi_align_window.reset_contract_stats()
    outputs = detector(case.frames)
    boxes, labels, scores, valid = outputs
    assert boxes.dtype == scores.dtype == np.float32 and boxes.shape == (2, 20, 4)
    assert np.isfinite(boxes[valid]).all() and np.isfinite(scores[valid]).all()
    windowed = options.get("roi_backend") == "windowed"
    assert roi_align_window.contract_stats() == {"rois": 200 if windowed else 0,
                                                 "out_of_contract": 0}
    if "compute_dtype" not in options:
        for got, want in zip(outputs, case.detector(case.frames)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["auto", "pallas", "gather"])
def test_every_exact_backend_is_the_same_function(backend):
    case = _case("tiny")
    cfg = det.DetectorConfig(**CONFIGS["tiny"], roi_backend=backend)
    detector = det.CaterDetector(cfg, state_dict=case.state, device="cpu")
    for got, want in zip(detector(case.frames), case.detector(case.frames)):
        np.testing.assert_array_equal(got, want)


def test_config_geometry_matches_jax():
    for kwargs in CONFIGS.values():
        ours, theirs = det.DetectorConfig(**kwargs), jdet.DetectorConfig(**kwargs)
        assert ours.scale == theirs.scale and ours.padded_hw == theirs.padded_hw
        assert ours.feature_shapes() == theirs.feature_shapes()
    assert det.DetectorConfig(**CONFIGS["full"]).padded_hw == (256, 320)
