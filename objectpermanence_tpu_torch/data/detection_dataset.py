"""Detection dataset: frame images + CSV box annotations, the port's copy of
`objectpermanence_tpu/data/detection_dataset.py`.

The reference's on-disk schema (`CaterObjectDetectionDataset`): a CSV with
columns `filename,object_class,X,Y,width,height`, one row per box, classes
by vocabulary name (or as an integer id), and a directory of images. Loads
into dense padded numpy arrays; the detector resizes the frames itself.
PIL is imported by `load_image` only, at its first call.
"""

import csv
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from objectpermanence_tpu_torch.vocab import OBJECTS_NAME_TO_IDX

MAX_GT_BOXES = 20  # CATER scenes have <= ~15 objects


def parse_annotations_csv(csv_path) -> Dict[str, List[Tuple[int, float, float, float, float]]]:
    """-> {filename: [(class_idx, x, y, w, h), ...]}"""
    per_image = defaultdict(list)
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            cls = row["object_class"]
            cls_idx = int(cls) if cls.isdigit() else OBJECTS_NAME_TO_IDX[cls]
            per_image[row["filename"]].append(
                (cls_idx, float(row["X"]), float(row["Y"]),
                 float(row["width"]), float(row["height"])))
    return dict(per_image)


class DetectionDataset:
    """Images + padded ground-truth arrays for the detector's train and
    eval loops."""

    def __init__(self, images_dir, annotations_csv, max_boxes: int = MAX_GT_BOXES):
        self.images_dir = Path(images_dir)
        self.annotations = parse_annotations_csv(annotations_csv)
        self.filenames = sorted(self.annotations)
        self.max_boxes = max_boxes

    def __len__(self):
        return len(self.filenames)

    def load_image(self, filename) -> np.ndarray:
        from PIL import Image
        with Image.open(self.images_dir / filename) as img:
            return np.asarray(img.convert("RGB"))

    def gt_arrays(self, filename):
        """-> (boxes (M, 4) xyxy, labels (M,), valid (M,)), padded to M."""
        rows = self.annotations[filename]
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.zeros(self.max_boxes, np.int32)
        valid = np.zeros(self.max_boxes, bool)
        for i, (cls, x, y, w, h) in enumerate(rows[:self.max_boxes]):
            boxes[i] = [x, y, x + w, y + h]
            labels[i] = cls
            valid[i] = True
        return boxes, labels, valid

    def batches(self, batch_size: int, *, shuffle: bool = False, seed: int = 0):
        """Batches of `batch_size` images in order (or shuffled by
        `RandomState(seed)`); the last batch repeats its final image."""
        idx = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        for start in range(0, len(self), batch_size):
            sel = idx[start:start + batch_size]
            if len(sel) < batch_size:  # repeat-pad the last batch
                sel = np.concatenate([sel, np.repeat(sel[-1:], batch_size - len(sel))])
            names = [self.filenames[i] for i in sel]
            images = np.stack([self.load_image(n) for n in names]).astype(np.float32)
            gts = [self.gt_arrays(n) for n in names]
            yield {
                "names": names,
                "images": images,
                "gt_boxes": np.stack([g[0] for g in gts]),
                "gt_labels": np.stack([g[1] for g in gts]),
                "gt_valid": np.stack([g[2] for g in gts]),
            }
