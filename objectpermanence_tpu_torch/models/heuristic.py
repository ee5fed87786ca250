"""Programmed (not learned) reasoners over raw per-frame detections, the
counterpart of `objectpermanence_tpu/models/heuristic.py`. Host numpy only.

Reference `baselines/programmed_models.py`: stateful per-video trackers with
a `track_for_frame(frame, frame_index, frames_predictions)` API that mutates
`state` (`target_pos`, `target_sz`, `snitch_box`) and `snitch_visible`.

- `HeuristicReasoner`: containment-stack logic over class-id detections
  (`programmed_models.py:71-167`).
- `ObjectDetectWithSiamTracker` is in `models/siam.py` (it runs the SiamRPN
  pixel tracker).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from objectpermanence_tpu_torch.vocab import SNITCH_CLASS_INDEX


def get_label_bb(frame_prediction: Dict[str, np.ndarray], label: int
                 ) -> Tuple[Tuple[int, int, int, int], Tuple[int, int, int, int]]:
    """First box of `label` in the frame -> ((cx, cy, w, h), (x1, y1, x2, y2));
    all -1 when absent (reference `detector.py:31-47`, with its floor-div
    centres)."""
    labels = np.asarray(frame_prediction["labels"]).reshape(-1)
    hits = np.flatnonzero(labels == label)
    if len(hits) == 0:
        return (-1, -1, -1, -1), (-1, -1, -1, -1)
    box = np.asarray(frame_prediction["bb"])[hits[0]]
    cx = (box[0] + box[2]) // 2
    cy = (box[1] + box[3]) // 2
    return (cx, cy, box[2] - box[0], box[3] - box[1]), tuple(box)


class AbstractReasoner:
    def __init__(self, index_to_track: int = SNITCH_CLASS_INDEX):
        self.index_to_track = index_to_track
        self.state: dict = {
            "target_pos": (-1, 1),
            "target_sz": (0, 0),
            "snitch_box": [-1, -1, -1, -1],
        }
        self.snitch_visible = False

    def track_for_frame(self, frame: Optional[np.ndarray], frame_index: int,
                        frames_predictions: Dict[str, List[np.ndarray]],
                        video_name: str = None) -> None:
        raise NotImplementedError


class HeuristicReasoner(AbstractReasoner):
    """Containment stack: when the snitch vanishes, follow the closest
    detected object (the presumed container); push and pop as carriers
    themselves vanish and reappear."""

    def __init__(self, index_to_track: int = SNITCH_CLASS_INDEX):
        super().__init__(index_to_track)
        self.stack: List[int] = []

    def track_for_frame(self, frame, frame_index, frames_predictions,
                        video_name=None) -> None:
        try:
            frame_prediction = {
                "bb": frames_predictions["bb"][frame_index],
                "labels": frames_predictions["labels"][frame_index],
            }
            (cx, cy, w, h), (x1, y1, x2, y2) = get_label_bb(
                frame_prediction, self.index_to_track)

            if cx >= 0 and cy >= 0:
                # the snitch is seen: snap to it and forget the history
                self.snitch_visible = True
                self.state["snitch_box"] = [x1, y1, x2, y2]
                self._update_state(cx, cy, w, h, self.index_to_track)
                self.stack = []
            elif len(self.stack) == 0:
                # the snitch just vanished: follow the closest object
                self.snitch_visible = False
                closest = self._closest_object_label(frame_prediction)
                (cx, cy, w, h), _ = get_label_bb(frame_prediction, closest)
                self._update_state(cx, cy, w, h, closest)
                self.stack.append(self.index_to_track)
            else:
                self.snitch_visible = False
                current = self.state["object_label"]
                (cx, cy, w, h), _ = get_label_bb(frame_prediction, current)

                if cx < 0 and cy < 0:
                    # the carrier vanished too: follow its container
                    closest = self._closest_object_label(frame_prediction)
                    (cx, cy, w, h), _ = get_label_bb(frame_prediction, closest)
                    self._update_state(cx, cy, w, h, closest)
                    self.stack.append(current)
                else:
                    prev = self.stack[-1]
                    (pcx, pcy, pw, ph), _ = get_label_bb(frame_prediction, prev)
                    if pcx >= 0 and pcy >= 0:
                        # the covered object reappeared: pop back to it
                        self._update_state(pcx, pcy, pw, ph, prev)
                        self.stack.pop()
                    else:
                        self._update_state(cx, cy, w, h, current)
        except ValueError:
            print(f"value error in frame {frame_index}, skipping action for "
                  f"this frame (snitch position is not updated)")

    def _closest_object_label(self, frame_prediction) -> int:
        cx, cy = self.state["target_pos"]
        boxes = np.asarray(frame_prediction["bb"], dtype=np.float64).reshape(-1, 4)
        centers = np.stack([(boxes[:, 0] + boxes[:, 2]) // 2,
                            (boxes[:, 1] + boxes[:, 3]) // 2], axis=-1)
        dist = np.linalg.norm(centers - np.array([cx, cy]), axis=1)
        closest = int(np.argmin(dist))
        return int(np.asarray(frame_prediction["labels"]).reshape(-1)[closest])

    def _update_state(self, cx, cy, w, h, object_label) -> None:
        self.state["target_pos"] = (cx, cy)
        self.state["target_sz"] = (w, h)
        self.state["object_label"] = object_label
        # object_sz keeps the size of the snitch itself
        if object_label == self.index_to_track:
            self.state["object_sz"] = (w, h)
