"""The port's detector against the benchmark's plain reference
(`benchmark/reference/faster_rcnn_r50_fpn.py`), on the CPU: stage by stage
at the published widths on 2 painted frames of 240 x 320 with the cell's
weights (`benchmark/models/faster_rcnn_r50_fpn.py`); the reference's
greedy NMS against the port's fixed-point `nms_mask` on boxes with tied
scores; and the `preprocess` kind run whole through `harness.run_cell` at
a small size."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.kinds import preprocess as kind
from benchmark.models import faster_rcnn_r50_fpn as adapter
from benchmark.reference import faster_rcnn_r50_fpn as reference
from objectpermanence_tpu_torch.models.detector import detector as port
from objectpermanence_tpu_torch.ops.nms import NEG_INF, batched_class_nms, nms_mask
from torch_lane import one_torch_thread  # noqa: F401

CELL = "faster_rcnn_r50_fpn.preprocess_c30"
CONFIG = json.loads((Path(harness.BENCH_DIR) / "configs" / "faster_rcnn_r50_fpn.json").read_text())
NEW_METRICS = ["host_syncs_per_call.preprocess", "backbone_ms_per_call.preprocess",
               "proposals_ms_per_call.preprocess", "heads_ms_per_call.preprocess",
               "mfu.preprocess", "roi_align_roofline.preprocess", "device_idle.preprocess"]


@pytest.fixture(scope="module")
def stages():
    """Both sides' stages on 2 frames of two cache videos, with the cell's
    weights (background bias calibrated on those frames)."""
    with np.load(harness.CACHE) as blob:
        cache = {k: blob[k] for k in blob.files}
    frames = np.concatenate([kind.paint_frames(cache["boxes"][v, 150:151], 40 + v)
                             for v in (7, 31)])
    images = torch.from_numpy(frames)
    weights = adapter.weights(CONFIG, 2**31 + 3, torch.device("cpu"))
    adapter.calibrate(CONFIG, weights, images, adapter.visible_objects_per_frame(cache))
    detector, chunk = adapter.build(CONFIG, weights, "cpu")
    config, model = detector.config, detector.model
    with torch.inference_mode():
        pyramid = port.forward_features(model, port.preprocess_images(images, config))
        proposals, proposal_scores = port.propose(model, pyramid, config, detector.anchors)
    ours = detector(frames)
    with torch.no_grad():  # `reference.forward`, its stages kept
        levels = reference.pyramid(weights, images, CONFIG)
        rois, roi_valid, _ = reference.proposals(weights, levels, CONFIG)
        theirs = reference.detections(*reference.box_logits(weights, levels, rois, CONFIG),
                                      rois, roi_valid, CONFIG)
    return {"chunk": chunk, "pyramid": (pyramid, levels),
            "proposals": (proposals, proposal_scores, rois, roi_valid),
            "detections": (ours, theirs)}


def test_the_program_is_built_as_preprocess_builds_it(stages):
    from objectpermanence_tpu_torch.config import preprocess_config_from

    shipped = json.loads((harness.ROOT / "configs" / "preprocess_config.json").read_text())
    assert CONFIG["preprocess_config"] == shipped
    _, overrides = preprocess_config_from(adapter.preprocess_config(CONFIG))
    config = port.DetectorConfig(**overrides)
    assert stages["chunk"] == 30 and config.padded_hw == (256, 320)
    assert (config.rpn_pre_nms_top_n, config.rpn_post_nms_top_n) == (500, 300)
    assert config == port.DetectorConfig(min_size=240, max_size=320, rpn_pre_nms_top_n=500,
                                         rpn_post_nms_top_n=300)


def test_the_pyramids_agree(stages):
    # float32 through 53 convolutions on both sides, whose summation orders
    # differ where the two take other algorithms (measured: 1.4e-5 of the
    # level's RMS at most); 1e-4 of the RMS, a TF32 rounding is 5e-4
    ours, theirs = stages["pyramid"]
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        rms = float(b.square().mean().sqrt())
        assert 0.1 < rms < 10  # the cell's scales keep every level near 1
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * rms)


def test_the_proposals_agree(stages):
    # the same candidates and NMS; the decodes differ by torchvision's
    # centre x1 + w / 2 against the port's (x1 + x2) / 2, a rounding of the
    # box's pixels (1e-3 px is a thousand times that at 320 px)
    proposals, scores, rois, roi_valid = stages["proposals"]
    valid = scores > NEG_INF / 10
    assert torch.equal(valid, roi_valid) and int(valid.sum()) == 600
    torch.testing.assert_close(proposals[valid], rois[roi_valid], rtol=0, atol=1e-3)


def test_the_detections_agree(stages):
    # the same detections; scores to the softmax's float32 rounding of the
    # slightly different boxes' pooled features, boxes to 1e-2 px
    (boxes, labels, scores, valid), theirs = stages["detections"]
    assert np.array_equal(valid, theirs["valid"].numpy())
    assert (valid & (scores >= 0.8)).sum() > 0
    assert np.array_equal(labels[valid], theirs["labels"].numpy()[valid])
    np.testing.assert_allclose(scores[valid], theirs["scores"].numpy()[valid], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(boxes[valid], theirs["boxes"].numpy()[valid], rtol=0, atol=1e-2)


def _tied_boxes(seed, rows, n, labels=False):
    """Boxes crowded in a small field, so that many overlap, with scores
    drawn from 5 values, so that many tie; a few entries padding."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(rows, n, 2, generator=g) * 40
    wh = 8 + torch.rand(rows, n, 2, generator=g) * 24
    boxes = torch.cat([xy, xy + wh], dim=-1)
    scores = torch.randint(1, 6, (rows, n), generator=g).float() / 5
    valid = torch.rand(rows, n, generator=g) > 0.1
    classes = torch.randint(1, 4, (rows, n), generator=g) if labels else None
    return boxes, scores, valid, classes


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_greedy_nms_matches_nms_mask_on_tied_scores(seed, threshold):
    boxes, scores, valid, _ = _tied_boxes(seed, 6, 64)
    ours = nms_mask(boxes, torch.where(valid, scores, torch.full_like(scores, NEG_INF)),
                    threshold)
    theirs = reference.greedy_nms(boxes, scores, valid, threshold)
    assert torch.equal(ours, theirs)
    assert 0 < int(theirs.sum()) < int(valid.sum())  # it suppressed


@pytest.mark.parametrize("seed", [3, 4])
def test_greedy_nms_within_a_class_matches_batched_class_nms(seed):
    boxes, scores, valid, classes = _tied_boxes(seed, 4, 48, labels=True)
    ours = batched_class_nms(boxes, torch.where(valid, scores, torch.full_like(scores, NEG_INF)),
                             classes, 0.5)
    theirs = reference.greedy_nms(boxes, scores, valid, 0.5, classes)
    assert torch.equal(ours, theirs)
    same_label_only = reference.greedy_nms(boxes, scores, valid, 0.5)
    assert int(theirs.sum()) > int(same_label_only.sum())  # classes kept apart


def test_the_flops_are_counted_layer_by_layer():
    # backbone 13.34 G, FPN 9.28 G, RPN head 8.10 G, box head on 300 rois 8.93 G
    assert adapter.flops_per_frame(CONFIG) == 39_652_300_800
    assert len(adapter.leaves(CONFIG)) == len(port.Detector(port.DetectorConfig()).state_dict())


def test_the_kind_runs_whole_on_the_cpu():
    manifest = harness.load_json(harness.MANIFEST)
    tiny = {**CONFIG, "backbone_layers": [1, 1, 1, 1], "backbone_width": 16, "fpn_channels": 32,
            "preprocess_config": {**CONFIG["preprocess_config"], "batch_size": 2}}
    mix = {"kind": "preprocess", "videos": 2, "frames": 4, "warmup": 1, "trace_calls": 1,
           "checked": 2}
    result, extra, compared = harness.run_cell(manifest, CELL, 2**33 + 19, 0.3, True,
                                               torch.device("cpu"), time.perf_counter(),
                                               config=tiny, mix=mix, log=lambda text: None)
    assert result["correct"] and result["attempted"] >= 1, compared
    assert {name for name, _, _ in compared} == {"kept_diff_per_frame", "det_diff_share",
                                                 "score_gap", "box_gap_px", "roi_launch_gap"}
    listed = [m["name"] for m in harness.metrics_of(manifest, CELL, trace=True)]
    assert listed == NEW_METRICS
    reported = result["metrics"]
    # on the CPU the device trace holds no device operation to read
    assert set(reported) == set(NEW_METRICS) - {"roi_align_roofline.preprocess",
                                                "device_idle.preprocess"}
    assert reported["host_syncs_per_call.preprocess"]["value"] == 0  # nothing blocks here
    for name in ("backbone_ms_per_call", "proposals_ms_per_call", "heads_ms_per_call"):
        assert reported[f"{name}.preprocess"]["value"] > 0
    assert reported["mfu.preprocess"]["value"] > 0
