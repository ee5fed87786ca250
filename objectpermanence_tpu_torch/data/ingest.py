"""Ingest: per-video perception pickles + GT jsons -> dense cached arrays.

The port's own copy of the pure-Python path of
`objectpermanence_tpu/data/ingest.py`: the padding/alignment and the
containment-oracle state machines run once at ingest, the result is cached
as a single `.npz`, and the model only touches dense `(V, 300, 15, F)`
arrays. The padding and the oracle run in the port's native C++ library
(`native/ingest.cc`, built at first use by `native/build.py`) unless the
caller asks for the Python path (`native=False`, or the JAX package's switch
`OP_TPU_DISABLE_NATIVE` set); both give the same arrays bit for bit.

Schema compatibility:
- input pickles: `{"bb": [ndarray (n_i, 4)] * 300, "labels": [ndarray (n_i,)] * 300}`
  (`baselines/preprocess_perception_main.py:91`)
- GT jsons: `{track_name: [[x, y, w, h]] * 300}` with the snitch under
  `small_gold_spl_metal_Spl_0` (`baselines/datasets.py:33-45`)
- containment annotation txt: `video_name\tframe,frame,...` lines
  (`baselines/datasets.py:460-475`)
"""

import functools
import hashlib
import json
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from objectpermanence_tpu_torch import MAX_OBJECTS_IN_FRAME, VIDEO_NUM_FRAMES
from objectpermanence_tpu_torch.vocab import IS_CONE, SNITCH_CLASS_INDEX, SNITCH_TRACK_NAME

SNITCH_SLOT = 0  # the snitch always occupies object slot 0

# normalizers: [w, h, w, h, 1] or [w, h, w, h, 1, 1]
_NORM5 = np.array([320.0, 240.0, 320.0, 240.0, 1.0])
_NORM6 = np.array([320.0, 240.0, 320.0, 240.0, 1.0, 1.0])


def slot_order(video_object_ids: Sequence[int]) -> List[int]:
    """Canonical per-video object->slot order: snitch first, then ascending
    class id (reference comparator, `datasets.py:47-54`)."""
    ids = sorted(set(int(i) for i in video_object_ids))
    if SNITCH_CLASS_INDEX in ids:
        ids.remove(SNITCH_CLASS_INDEX)
        ids.insert(0, SNITCH_CLASS_INDEX)
    return ids


def pad_video_detections(frame_boxes: List[np.ndarray], frame_labels: List[np.ndarray],
                         feature_width: int) -> np.ndarray:
    """Align raw per-frame detections to the canonical slot order and pad to
    a dense `(T, 15, F)` float32 array, normalized.

    Semantics match the reference's lockstep merge walk
    (`datasets.py:130-196` / `:265-336`): first detection per class wins
    (perception duplicates dropped), classes ranked beyond 15 slots are
    discarded, missing objects become zero rows with visible=0 — except that
    in the 6-feature layout a missing *cone* keeps its cone bit set so the
    model can reason about the (invisible) container.
    """
    assert feature_width in (5, 6)
    num_frames = len(frame_labels)
    order = slot_order(np.concatenate([np.asarray(l).reshape(-1) for l in frame_labels])
                       if num_frames else [])
    slot_of = {obj: slot for slot, obj in enumerate(order)}
    num_slots = min(len(order), MAX_OBJECTS_IN_FRAME)

    out = np.zeros((num_frames, MAX_OBJECTS_IN_FRAME, feature_width), dtype=np.float64)
    cone_slot = np.zeros(MAX_OBJECTS_IN_FRAME, dtype=bool)
    for obj, slot in slot_of.items():
        if slot < num_slots and IS_CONE[obj]:
            cone_slot[slot] = True

    for f in range(num_frames):
        labels = np.asarray(frame_labels[f]).reshape(-1)
        boxes = np.asarray(frame_boxes[f]).reshape(-1, 4) if len(labels) else np.zeros((0, 4))
        seen = set()
        max_slot = -1
        for obj, bb in zip(labels, boxes):
            obj = int(obj)
            if obj in seen:
                continue  # duplicate detection: keep the first (highest score)
            seen.add(obj)
            slot = slot_of[obj]
            max_slot = max(max_slot, slot)
            if slot >= num_slots:
                continue
            out[f, slot, :4] = bb
            out[f, slot, 4] = 1.0
            if feature_width == 6:
                out[f, slot, 5] = float(IS_CONE[obj])
        if feature_width == 6:
            # Reference quirk (`datasets.py:288-320`): a missing cone keeps
            # its cone bit only while the frame's merge walk is still
            # consuming detections — i.e. for slots before the last detected
            # slot. Missing slots after the final detection are filled by
            # the generic zero-padding loop and lose the cone bit.
            limit = min(max_slot, num_slots)
            for slot in range(max(limit, 0)):
                if cone_slot[slot] and not out[f, slot, 4]:
                    out[f, slot, 5] = 1.0

    norm = _NORM5 if feature_width == 5 else _NORM6
    return (out / norm).astype(np.float32)


def _centers(rows: np.ndarray) -> np.ndarray:
    return np.stack([(rows[:, 0] + rows[:, 2]) / 2, (rows[:, 1] + rows[:, 3]) / 2], axis=-1)


def _closest_slot(frame: np.ndarray, last_location: np.ndarray) -> int:
    """argmin over all 15 slots of center distance to the last known
    location (reference `datasets.py:100-108`; padding rows compete with
    center (0,0), matching the reference exactly)."""
    centers = _centers(frame)
    last_center = np.array([(last_location[0] + last_location[2]) / 2,
                            (last_location[1] + last_location[3]) / 2])
    return int(np.argmin(np.linalg.norm(centers - last_center, axis=1)))


def containment_oracle_5(padded: np.ndarray) -> np.ndarray:
    """5-feature containment oracle (reference `datasets.py:199-257`):
    per-frame slot index carrying the "snitch signal". Visible snitch ->
    slot 0 and clear the stack; snitch vanished -> nearest object becomes
    the carrier (push); carrier vanished -> recurse; covered object
    reappears -> pop."""
    track = np.zeros(len(padded), dtype=np.int32)
    stack: List[int] = []
    last = np.zeros(padded.shape[-1])
    current = SNITCH_SLOT

    for f, frame in enumerate(padded):
        if frame[SNITCH_SLOT, 4]:
            track[f] = SNITCH_SLOT
            last = frame[SNITCH_SLOT]
            current = SNITCH_SLOT
            stack = []
        elif current == SNITCH_SLOT:
            closest = _closest_slot(frame, last)
            track[f] = closest
            last = frame[closest]
            current = closest
            stack.append(SNITCH_SLOT)
        else:
            if not frame[current, 4]:
                closest = _closest_slot(frame, last)
                track[f] = closest
                last = frame[closest]
                stack.append(current)
                current = closest
            else:
                prev = stack[-1]
                if frame[prev, 4]:
                    track[f] = prev
                    last = frame[prev]
                    current = prev
                    stack.pop()
                else:
                    track[f] = current
                    last = frame[current]
    return track


def containment_oracle_6(padded: np.ndarray) -> np.ndarray:
    """6-feature oracle (reference `datasets.py:338-416`): like the 5-track
    oracle but containment transfer only happens when the nearest object is
    a cone; otherwise the disappearance is treated as occlusion and the
    snitch slot keeps being tracked from its frozen last location."""
    track = np.zeros(len(padded), dtype=np.int32)
    stack: List[int] = []
    last = np.zeros(padded.shape[-1])
    current = SNITCH_SLOT

    for f, frame in enumerate(padded):
        if frame[SNITCH_SLOT, 4]:
            track[f] = SNITCH_SLOT
            last = frame[SNITCH_SLOT]
            current = SNITCH_SLOT
            stack = []
        elif current == SNITCH_SLOT:
            closest = _closest_slot(frame, last)
            if frame[closest, 5]:  # cone -> containment
                track[f] = closest
                last = frame[closest]
                current = closest
                stack.append(SNITCH_SLOT)
            else:  # occlusion -> keep tracking the snitch, frozen location
                track[f] = SNITCH_SLOT
                current = SNITCH_SLOT
        else:
            if not frame[current, 4]:
                closest = _closest_slot(frame, last)
                if frame[closest, 5]:
                    track[f] = closest
                    last = frame[closest]
                    stack.append(current)
                    current = closest
                else:
                    track[f] = current  # location and carrier unchanged
            else:
                prev = stack[-1]
                if frame[prev, 4]:
                    stack.pop()
                    track[f] = prev
                    last = frame[prev]
                    current = prev
                else:
                    track[f] = current
                    last = frame[current]
    return track


def containment_oracle(padded: np.ndarray, feature_width: int) -> np.ndarray:
    return containment_oracle_5(padded) if feature_width == 5 else containment_oracle_6(padded)


def load_snitch_labels(labels_path) -> np.ndarray:
    """GT snitch boxes from a `<name>_bb.json`: xywh -> xyxy, normalized
    (reference `datasets.py:33-45`)."""
    with open(labels_path) as f:
        video_labels = json.load(f)
    raw = np.asarray(video_labels[SNITCH_TRACK_NAME], dtype=np.float64)
    xyxy = np.stack([raw[:, 0], raw[:, 1], raw[:, 0] + raw[:, 2], raw[:, 1] + raw[:, 3]],
                    axis=-1)
    return (xyxy / np.array([320.0, 240.0, 320.0, 240.0])).astype(np.float32)


def parse_containment_annotations(path, video_names: Sequence[str],
                                  num_frames: int = VIDEO_NUM_FRAMES) -> Dict[str, np.ndarray]:
    """Tab-separated `video\tf1,f2,...` -> per-video boolean frame mask
    (reference `datasets.py:460-475`)."""
    wanted = set(video_names)
    masks = {name: np.zeros(num_frames, dtype=bool) for name in video_names}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            name, frames_str = line.split("\t")
            if name not in wanted:
                continue
            if frames_str:
                frames = np.array(frames_str.split(","), dtype=np.int64)
                masks[name][frames] = True
    return masks


def _cache_key(predictions_dir: Path, labels_dir: Path, feature_width: int,
               names: Sequence[str]) -> str:
    h = hashlib.sha256()
    h.update(f"{predictions_dir}|{labels_dir}|{feature_width}|torch-v1".encode())
    for name in names:
        pkl = predictions_dir / f"{name}.pkl"
        h.update(f"{name}:{pkl.stat().st_mtime_ns}:{pkl.stat().st_size}".encode())
    return h.hexdigest()[:16]


class IngestedDataset:
    """Dense, device-layout-friendly dataset of ingested videos."""

    def __init__(self, names: List[str], boxes: np.ndarray, index_to_track: np.ndarray,
                 labels: np.ndarray, containment_mask: Optional[np.ndarray] = None):
        self.names = names
        self.boxes = boxes                      # (V, T, 15, F) float32
        self.index_to_track = index_to_track    # (V, T) int32
        self.labels = labels                    # (V, T, 4) float32
        # (V, T, 4) bool — containment frames broadcast over box coords,
        # shaped like the reference's per-sample mask (`datasets.py:487-488`)
        self.containment_mask = containment_mask

    def __len__(self):
        return len(self.names)

    @property
    def feature_width(self):
        return self.boxes.shape[-1]


def training_mask_file(spec, split_dir) -> Path:
    """The dataset 'mask' doubles as the TRAINING loss mask: `*_no_labels`
    models multiply the L1 loss by a VISIBLE-frames mask ("mask contains
    only visible objects", reference `baselines/training_main.py:199-201`),
    i.e. those experiments feed a visible-frames annotations file where the
    standard models feed the containment file (used only for the
    contained-mIoU eval metric). Feeding the containment file to a
    no_labels model supervises exactly the frames where the snitch is
    hidden — backwards — and collapses training (observed: dev mIoU 0.06).
    Shared by every training driver so the selection can never diverge."""
    split_dir = Path(split_dir)
    if spec.no_labels:
        return split_dir / "od_perception" / "visibility_rate_gt_0.99.txt"
    return split_dir / "annotations" / "containment_annotations.txt"


def ingest_directory(predictions_dir, labels_dir, feature_width: int,
                     containment_file=None, cache_dir=None,
                     native: Optional[bool] = None) -> IngestedDataset:
    """Scan `predictions_dir/*.pkl`, pair with `labels_dir/<name>_bb.json`,
    run pad/align + the containment oracle once, and cache everything as a
    single npz keyed by the input files' mtimes. `native` (default: unless
    `OP_TPU_DISABLE_NATIVE` is set) runs them in the C++ library, which
    raises if it cannot be built; `native=False` in Python."""
    if native is None:
        native = not os.environ.get("OP_TPU_DISABLE_NATIVE")
    predictions_dir, labels_dir = Path(predictions_dir), Path(labels_dir)
    names = sorted(p.stem for p in predictions_dir.glob("*.pkl"))
    if not names:
        raise FileNotFoundError(f"no perception pickles found in {predictions_dir}")

    cache_path = None
    if cache_dir is not None:
        cache_dir = Path(cache_dir)
        cache_dir.mkdir(parents=True, exist_ok=True)
        key = _cache_key(predictions_dir, labels_dir, feature_width, names)
        cache_path = cache_dir / f"ingest_{key}.npz"

    if cache_path is not None and cache_path.exists():
        with np.load(cache_path, allow_pickle=False) as blob:
            boxes, track, labels = blob["boxes"], blob["index_to_track"], blob["labels"]
    else:
        if native:
            from objectpermanence_tpu_torch.native.build import (
                native_containment_oracle, native_pad_video,
            )
            pad = functools.partial(native_pad_video, is_cone=IS_CONE)
            oracle = native_containment_oracle
        else:
            pad, oracle = pad_video_detections, containment_oracle
        all_boxes, all_track, all_labels = [], [], []
        for name in names:
            with open(predictions_dir / f"{name}.pkl", "rb") as f:
                pred = pickle.load(f)
            padded = pad(pred["bb"], pred["labels"], feature_width)
            track = oracle(padded, feature_width)
            all_boxes.append(padded)
            all_track.append(track)
            all_labels.append(load_snitch_labels(labels_dir / f"{name}_bb.json"))
        boxes = np.stack(all_boxes)
        track = np.stack(all_track)
        labels = np.stack(all_labels)
        if cache_path is not None:
            # atomic: data-parallel ranks ingest the same files at once
            tmp = cache_path.with_suffix(f".{os.getpid()}.tmp")
            with open(tmp, "wb") as f:
                np.savez_compressed(f, boxes=boxes, index_to_track=track, labels=labels)
            os.replace(tmp, cache_path)

    containment = None
    if containment_file is not None:
        masks = parse_containment_annotations(containment_file, names, boxes.shape[1])
        containment = np.stack([masks[n] for n in names])[..., None].repeat(4, axis=-1)

    return IngestedDataset(names, boxes, track, labels, containment)


def batches(dataset: IngestedDataset, batch_size: int):
    """Yield dense batch dicts in dataset order; the last may be smaller.
    (Training shuffles and pads its batches in `train/loop.py::DeviceDataset`.)"""
    count = len(dataset)
    idx = np.arange(count)
    for start in range(0, count, batch_size):
        sel = idx[start:start + batch_size]
        batch = {
            "boxes": dataset.boxes[sel],
            "index_to_track": dataset.index_to_track[sel],
            "labels": dataset.labels[sel],
            "names": [dataset.names[i] for i in sel],
        }
        if dataset.containment_mask is not None:
            batch["mask"] = dataset.containment_mask[sel]
        else:
            batch["mask"] = np.zeros(batch["labels"].shape, dtype=bool)
        yield batch
