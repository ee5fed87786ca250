"""The `preprocess` cell's check: the control (the reference in TF32) fails
its limits at the published widths on a few frames the CPU can hold, a
run with a fault planted in the detector comes out not correct, and the
frame painter is fixed by its seed. On the card, one short run of the
cell from a fresh process is correct."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.kinds import preprocess

CELL = "faster_rcnn_r50_fpn.preprocess_c30"
# a small net, and 20 detections a frame, so that one detection a frame is
# several times the limit of `det_diff_share`
SMALL = {"backbone_layers": [1, 1, 1, 1], "backbone_width": 16, "fpn_channels": 32,
         "detections_per_img": 20}
MIX = {"kind": "preprocess", "videos": 2, "frames": 4, "warmup": 1, "trace_calls": 1,
       "checked": 2}


def _config(**changes):
    config = harness.load_json(harness.BENCH_DIR / "configs" / "faster_rcnn_r50_fpn.json")
    return {**config, **changes,
            "preprocess_config": {**config["preprocess_config"], "batch_size": 2}}


def test_tf32_fails_the_cell(manifest):
    ctx = harness.context(manifest, CELL, 2**32 + 9, torch.device("cpu"), _config())
    ctx.log = lambda text: None
    frames = preprocess.paint_frames(ctx.cache["boxes"][12, 100:102], 5)
    weights = ctx.adapter.weights(ctx.config, 5, ctx.device)
    background = ctx.adapter.calibrate(ctx.config, weights, torch.from_numpy(frames),
                                       ctx.adapter.visible_objects_per_frame(ctx.cache))
    state = {"pool": [frames], "videos": np.array([12]), "weights": weights, "chunk": 2,
             "kept": [(0, 0, None, None)], "roi_launch_gap": 0, "background": background,
             "calibration_s": 0.0, "window_kept": 0, "window_frames": 0}
    ok, compared = harness.judge(ctx, preprocess.numbers(ctx, state, precision="tf32"))
    assert not ok, compared


def _run(manifest, seed=2**33 + 23, log=lambda text: None, **changes):
    result, _, compared = harness.run_cell(manifest, CELL, seed, 0.2, False, torch.device("cpu"),
                                           0.0, config=_config(**{**SMALL, **changes}), mix=MIX,
                                           log=log)
    return result, compared


def test_a_sound_run_is_correct(manifest):
    result, compared = _run(manifest)
    assert result["correct"], compared


def _planted(monkeypatch, fault):
    from objectpermanence_tpu_torch.models.detector import detector

    plain = detector.detect_forward

    def altered(*args):
        boxes, labels, scores, valid = plain(*args)
        return fault(boxes.clone(), labels, scores, valid.clone())

    monkeypatch.setattr(detector, "detect_forward", altered)


def test_a_shifted_box_is_caught(manifest, monkeypatch):
    def shift(boxes, labels, scores, valid):
        boxes[:, 0] += 2.0  # each frame's best detection 2 px to the right
        return boxes, labels, scores, valid

    _planted(monkeypatch, shift)
    result, compared = _run(manifest)
    assert not result["correct"], compared


@pytest.mark.parametrize("detections", [20, 100])
def test_a_dropped_detection_is_caught(manifest, monkeypatch, detections):
    """Each frame's best detection left out. At the published 100
    detections an image, on a seed whose frames fill them, one detection a
    frame is under `det_diff_share`'s limit; the lists' `kept_diff_per_frame`
    catches it."""
    def drop(boxes, labels, scores, valid):
        valid[:, 0] = False
        return boxes, labels, scores, valid

    _planted(monkeypatch, drop)
    logs = []
    result, compared = _run(manifest, log=logs.append, detections_per_img=detections)
    assert not result["correct"], compared
    values = {name: (value, limit) for name, value, limit in compared}
    assert values["kept_diff_per_frame"][0] > values["kept_diff_per_frame"][1], compared
    if detections == 100:
        seen = json.loads(next(line for line in logs if line.startswith("checked: "))[9:])
        assert seen["valid_per_frame"] >= 95
        assert values["det_diff_share"][0] <= values["det_diff_share"][1], compared


def test_the_painter_is_fixed_by_its_seed(manifest):
    ctx = harness.context(manifest, CELL, 1, torch.device("cpu"))
    boxes = ctx.cache["boxes"][3, :6]
    one, two = preprocess.paint_frames(boxes, 77), preprocess.paint_frames(boxes, 77)
    assert one.dtype == np.uint8 and one.shape == (6, 240, 320, 3)
    assert np.array_equal(one, two)
    assert not np.array_equal(one, preprocess.paint_frames(boxes, 78))
    # one visible box alone: its top-left pixel in its slot's colour, lit by
    # 1.15; the floor elsewhere within the floor's range and its noise
    t, k = map(int, np.argwhere(boxes[..., 4] > 0.5)[0])
    single = boxes.copy()
    single[..., 4] = 0
    single[t, k, 4] = 1
    frames = preprocess.paint_frames(single, 77)
    x1, y1, x2, y2 = np.round(boxes[t, k, :4] * preprocess.PIXELS).astype(int)
    colour = np.clip(preprocess.slot_colours(boxes.shape[1])[k] * 1.15, 0, 255)
    assert np.array_equal(frames[t, y1, x1], colour.astype(np.uint8))
    floor = np.delete(frames[t].reshape(-1, 3), [y * 320 + x for y in range(y1, y2)
                                                  for x in range(x1, x2)], axis=0)
    assert floor.min() >= 90 - 8 and floor.max() <= 149 + 8


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct(cuda_card):
    proc = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload", CELL,
                           "--seed", "2147483777", "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
    assert result["checks"]["roi_launch_gap"]["value"] == 0
