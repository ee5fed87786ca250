"""The `preprocess` kind: one client runs videos through the port's
detector in a closed loop, one video in flight, as
`infer/preprocess.py::preprocess_main` runs them:
`CaterDetector.detect_video(frames, chunk)` and then `detections_to_lists`,
the pickles' ragged >= 0.8 schema. A request is one video of uint8 RGB
frames in pageable host memory; it completes when its lists are on the host.

The weights are the seed's (`models/faster_rcnn_r50_fpn.py`), with the
background class's bias calibrated on 30 frames of each pool video before
the window's clock starts: the calibration runs the reference, so, like
the check, it is neither set-up nor window (`calibration_s`). The
frames are painted once in set-up (decoding is not timed:
`preprocess_main` decodes on threads ahead of the card) from videos of the
frozen ingest cache that the seed draws: each visible cached box is a
filled box shaded top to bottom in its slot's colour, on a textured grey
floor with fresh sensor noise in every frame, as
`data/fixtures.py::draw_frames` paints a scene (a frozen copy, by commit
443ce38's painter).

Mix keys: `videos`, the pool of painted videos requests cycle over;
`frames` a video; `warmup`, requests before the window; `trace_calls`,
requests in the profiled stretch; `checked`, the chunks, drawn by a seeded
reservoir over the window's chunks, whose outputs are compared with the
reference. The chunk is the configuration's `preprocess_config.batch_size`.
"""

from contextlib import nullcontext
from time import perf_counter

import numpy as np
import torch

from benchmark import stats
from benchmark.kinds import Window

HEIGHT, WIDTH = 240, 320
PIXELS = np.array([WIDTH, HEIGHT, WIDTH, HEIGHT], np.float32)
MATCH_IOU = 0.99
CALIBRATION_FRAMES = 30  # of each pool video, evenly spaced, for the background bias


def slot_colours(slots):
    """A fixed RGB colour for each object slot."""
    return [np.random.RandomState(1000 + k).randint(20, 236, 3) for k in range(slots)]


def paint_frames(boxes, seed):
    """One video's cached boxes `(T, 15, 6)` (normalised [x1, y1, x2, y2,
    visible, is_cone]) -> `(T, 240, 320, 3)` uint8 RGB frames: a floor drawn
    once from `seed`, noise in every frame, each visible box filled in its
    slot's colour, shaded from 1.15 at its top to 0.8 at its bottom."""
    rng = np.random.default_rng(seed)
    floor = rng.integers(90, 150, (HEIGHT, WIDTH, 3), dtype=np.int16)
    frames = floor + rng.integers(-8, 9, (len(boxes), HEIGHT, WIDTH, 3), dtype=np.int16)
    colours = slot_colours(boxes.shape[1])
    pixels = np.round(boxes[..., :4] * PIXELS).astype(int)
    for t, k in zip(*np.nonzero(boxes[..., 4] > 0.5)):
        x1, y1, x2, y2 = pixels[t, k]
        shade = np.linspace(1.15, 0.8, max(y2 - y1, 1))[:, None, None]
        frames[t, y1:y2, x1:x2] = colours[k] * shade
    return np.clip(frames, 0, 255).astype(np.uint8)


def _roi_counter():
    from objectpermanence_tpu_torch.ops.roi_align_kernel import roi_align_batched
    return roi_align_batched


def setup(ctx):
    mix, adapter = ctx.mix, ctx.adapter
    draws = np.random.default_rng(stats.subseed(ctx.seed, "inputs")).integers(
        0, ctx.cache["boxes"].shape[0], size=mix["videos"])
    pool = [paint_frames(ctx.cache["boxes"][v, :mix["frames"]],
                         stats.subseed(ctx.seed, f"frames{i}")) for i, v in enumerate(draws)]
    ctx.log("frames painted")
    weights = adapter.weights(ctx.config, stats.subseed(ctx.seed, "weights"), ctx.device)
    detector, chunk = adapter.build(ctx.config, weights, ctx.device)
    ctx.log("weights made, detector built")
    state = {"pool": pool, "videos": draws, "weights": weights, "detector": detector,
             "chunk": chunk, "rng": np.random.default_rng(stats.subseed(ctx.seed, "checked")),
             "kept": [], "chunks_seen": 0, "window_kept": 0, "window_frames": 0}
    for i in range(mix["warmup"]):
        _request(state, i)
    ctx.log(f"{mix['warmup']} warm-up requests")
    return state


def _calibrate(ctx, state):
    """Set the background class's bias of the reference's weights and of the
    built detector (`adapter.calibrate`) on `CALIBRATION_FRAMES` evenly
    spaced frames of each pool video. The warm-up ran at the bias 0: it
    meets the same shapes."""
    frames = np.concatenate([v[::max(len(v) // CALIBRATION_FRAMES, 1)][:CALIBRATION_FRAMES]
                             for v in state["pool"]])
    start = perf_counter()
    state["background"] = ctx.adapter.calibrate(
        ctx.config, state["weights"], torch.from_numpy(frames).to(ctx.device),
        ctx.adapter.visible_objects_per_frame(ctx.cache))
    ctx.adapter.reload(state["detector"], state["weights"])
    state["calibration_s"] = perf_counter() - start


def _request(state, index):
    """One video through `detect_video` and `detections_to_lists` ->
    (the dense outputs, the lists)."""
    from objectpermanence_tpu_torch.infer.preprocess import detections_to_lists

    frames = state["pool"][index % len(state["pool"])]
    dense = state["detector"].detect_video(frames, state["chunk"])
    return dense, detections_to_lists(*dense)


def _keep(state, checked, index, dense, lists):
    """Offer each chunk of request `index` to the seeded reservoir of
    `checked` chunks, and count the request's listed detections."""
    chunk, kept, rng = state["chunk"], state["kept"], state["rng"]
    state["window_kept"] += sum(len(b) for b in lists["bb"])
    state["window_frames"] += len(lists["bb"])
    for start in range(0, len(dense[0]), chunk):
        part = slice(start, start + chunk)
        item = (index % len(state["pool"]), start, tuple(a[part] for a in dense),
                {k: v[part] for k, v in lists.items()})
        n = state["chunks_seen"]
        if len(kept) < checked:
            kept.append(item)
        else:
            slot = int(rng.integers(0, n + 1))
            if slot < checked:
                kept[slot] = item
        state["chunks_seen"] = n + 1


def _loop(ctx, state, span, stop, keep):
    i, call_s = 0, []
    while not stop(i):
        t = perf_counter()
        with span("bench.preprocess.call"):
            dense, lists = _request(state, i)
        call_s.append(perf_counter() - t)
        if keep:
            _keep(state, ctx.mix["checked"], i, dense, lists)
        i += 1
    return i, call_s


def window(ctx, state, seconds, span=lambda name: nullcontext()):
    if "background" not in state:
        _calibrate(ctx, state)
    counter = _roi_counter()
    before = counter.launches
    start = perf_counter()
    deadline = start + seconds
    requests, call_s = _loop(ctx, state, span, lambda i: perf_counter() >= deadline, keep=True)
    elapsed = perf_counter() - start
    chunks = requests * -(-ctx.mix["frames"] // state["chunk"])
    # K7 once a chunk on the card; off the card the plain RoIAlign launches nothing
    expected = chunks if ctx.device.type == "cuda" else 0
    state["roi_launch_gap"] = abs(counter.launches - before - expected)
    return Window(attempted=requests, frames=requests * ctx.mix["frames"], seconds=elapsed,
                  host_call_s=call_s)


def stretch(ctx, state, span):
    calls = ctx.mix["trace_calls"]
    _loop(ctx, state, span, lambda i: i >= calls, keep=False)
    return calls


def expected_launches(ctx, state, attempted):
    """No reasoner kernel runs (K7's count is `roi_launch_gap`, a checked
    number)."""
    return {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


def release(state):
    state.pop("detector", None)


def _pairs(a_boxes, a_labels, b_boxes, b_labels):
    """For each detection of side a, its best partner on side b (same label,
    largest IoU) -> (matched (na,), partner index (na,))."""
    from benchmark.reference.faster_rcnn_r50_fpn import box_iou

    if len(a_boxes) == 0 or len(b_boxes) == 0:
        return np.zeros(len(a_boxes), bool), np.zeros(len(a_boxes), int)
    iou = box_iou(torch.as_tensor(a_boxes, dtype=torch.float64),
                  torch.as_tensor(b_boxes, dtype=torch.float64))
    iou = torch.where(torch.as_tensor(a_labels)[:, None] == torch.as_tensor(b_labels)[None],
                      iou, torch.full_like(iou, -1.0))
    best, partner = iou.max(dim=1)
    return (best >= MATCH_IOU).numpy(), partner.numpy()


class _Tally:
    """Detections without a partner on the other side, and both sides'
    count; the widest score and coordinate gaps of matched pairs."""

    def __init__(self):
        self.unmatched, self.total, self.score_gap, self.box_gap = 0, 0, 0.0, 0.0

    def add(self, a, b, scores=False):
        """`a`, `b`: (boxes, labels[, scores]) of one frame on each side."""
        ab, pa = _pairs(a[0], a[1], b[0], b[1])
        ba, _ = _pairs(b[0], b[1], a[0], a[1])
        self.unmatched += int((~ab).sum() + (~ba).sum())
        self.total += len(a[0]) + len(b[0])
        if ab.any():
            self.box_gap = max(self.box_gap, float(np.abs(a[0][ab] - b[0][pa[ab]]).max()))
            if scores:
                self.score_gap = max(self.score_gap,
                                     float(np.abs(a[2][ab] - b[2][pa[ab]]).max()))

    def share(self):
        return self.unmatched / self.total if self.total else 0.0

    def add_kept(self, listed, truth, kept_score, band):
        """The lists' test of one frame: each listed detection (boxes,
        labels) needs a partner among the reference's detections scored at
        least `kept_score - band`, and each of the reference's scored at
        least `kept_score + band` a partner among the listed ones. A
        detection within `band` of the kept score may cross it by rounding;
        one farther off may not. `truth`: the reference's (boxes, labels,
        scores) of its valid detections."""
        near, sure = truth[2] >= kept_score - band, truth[2] >= kept_score + band
        listed_ok, _ = _pairs(listed[0], listed[1], truth[0][near], truth[1][near])
        truth_ok, _ = _pairs(truth[0][sure], truth[1][sure], listed[0], listed[1])
        self.unmatched += int((~listed_ok).sum() + (~truth_ok).sum())


def _reference(ctx, state, video, start, precision):
    frames = torch.from_numpy(state["pool"][video][start:start + state["chunk"]])
    return ctx.reference.forward(state["weights"], frames.to(ctx.device), ctx.config, precision)


def numbers(ctx, state, precision="fp32"):
    """Over the kept chunks, the program's outputs (with `precision` other
    than "fp32", the reference in that precision: the control) against the
    reference's: `kept_diff_per_frame`, the detections at or above the
    kept score (the lists `preprocess` writes) with no partner of the same
    label at IoU >= 0.99 on the other side, a checked frame, where a
    detection within `score_gap`'s limit of the kept score may find its
    partner on either side of it (`_Tally.add_kept`);
    `det_diff_share`, the same over every valid detection (score >= 0.05);
    `score_gap` and `box_gap_px`, the widest score and pixel gaps among
    matched valid pairs; `roi_launch_gap`, K7's launches in the window less
    its chunks. Besides, what the weights do: kept and valid detections a
    frame in the checked chunks, listed detections a frame over the window,
    the reference's pyramid RMS, NMS suppression and most candidates an
    image, the background bias and the calibration's seconds."""
    cache = state.setdefault("reference", {})
    kept_score = ctx.config["kept_score"]
    band = ctx.limits["numbers"]["score_gap"]["limit"]

    def reference(video, start, precision):
        if (precision, video, start) not in cache:
            out = _reference(ctx, state, video, start, precision)
            cache[(precision, video, start)] = (
                {k: out[k].cpu().numpy() for k in ("boxes", "labels", "scores", "valid")},
                out["stats"])
        return cache[(precision, video, start)]

    kept, valid = _Tally(), _Tally()
    counts = {"kept": 0, "valid": 0, "frames": 0}
    found = []
    for video, start, dense, lists in state["kept"]:
        truth, seen = reference(video, start, "fp32")
        found.append(seen)
        if precision == "fp32":
            boxes, labels, scores, ok = dense
            ours_kept = list(zip(lists["bb"], lists["labels"]))
        else:
            other = reference(video, start, precision)[0]
            boxes, labels, scores, ok = (other[k] for k in ("boxes", "labels", "scores", "valid"))
            top = ok & (scores >= kept_score)
            ours_kept = [(boxes[f][top[f]], labels[f][top[f]]) for f in range(len(boxes))]
        t_ok = truth["valid"]
        for f in range(len(boxes)):
            t_valid = tuple(truth[k][f][t_ok[f]] for k in ("boxes", "labels", "scores"))
            kept.add_kept(ours_kept[f], t_valid, kept_score, band)
            valid.add((boxes[f][ok[f]], labels[f][ok[f]], scores[f][ok[f]]), t_valid,
                      scores=True)
            counts["kept"] += len(ours_kept[f][0])
            counts["valid"] += int(ok[f].sum())
            counts["frames"] += 1
    frames = max(counts["frames"], 1)
    return {"kept_diff_per_frame": kept.unmatched / frames, "det_diff_share": valid.share(),
            "score_gap": valid.score_gap, "box_gap_px": valid.box_gap,
            "roi_launch_gap": state["roi_launch_gap"],
            "kept_per_frame": counts["kept"] / frames, "valid_per_frame": counts["valid"] / frames,
            "window_kept_per_frame": state["window_kept"] / max(state["window_frames"], 1),
            "visible_per_frame": float((ctx.cache["boxes"][state["videos"], ..., 4] > 0.5)
                                       .sum(-1).mean()),
            "level_rms": [max(s["level_rms"][i] for s in found) for i in range(5)] if found else [],
            "rpn_suppressed": min((s["rpn_suppressed"] for s in found), default=0.0),
            "class_suppressed": min((s["class_suppressed"] for s in found), default=0.0),
            "candidates_max": max((s["candidates_max"] for s in found), default=0),
            "background_bias": state["background"], "calibration_s": state["calibration_s"],
            "checked": len(state["kept"])}
