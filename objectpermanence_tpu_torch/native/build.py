"""Build and load the port's native ingest library (`native/ingest.cc`).

The library is compiled with `g++ -O3 -shared -fPIC -std=c++17` at its
first use into `build/torch_native/` at the repository root, named by a hash
of the source and the flags, so a changed source is rebuilt and an unchanged
one reused; it is loaded with ctypes (a plain C interface). A failed build or
load raises with the compiler's output: nothing falls back to the Python
path, which runs only where the caller asks for it (`data/ingest.py`).
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "ingest.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
COMPILER = "g++"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIBS: Dict[Path, ctypes.CDLL] = {}


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join([COMPILER, *FLAGS]).encode())
    return BUILD_DIR / f"libingest_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source's build exists; raises with the
    compiler's output if it fails."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [COMPILER, *FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"native ingest build failed: {' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native ingest build failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent process never loads a partial file
    return path


def load_ingest_library() -> ctypes.CDLL:
    """The native ingest library, built on first use."""
    path = build()
    if path not in _LIBS:
        lib = ctypes.CDLL(str(path))
        lib.pad_video.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ]
        lib.containment_oracle.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pad_video.restype = lib.containment_oracle.restype = None
        _LIBS[path] = lib
    return _LIBS[path]


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_pad_video(frame_boxes: Sequence[np.ndarray], frame_labels: Sequence[np.ndarray],
                     feature_width: int, is_cone: np.ndarray) -> np.ndarray:
    """`data/ingest.py::pad_video_detections` in C++: the detections aligned
    to the canonical slots, `(T, 15, F)` float32, normalized. Boxes are read
    as float32."""
    if feature_width not in (5, 6):
        raise ValueError(f"feature_width must be 5 or 6, not {feature_width}")
    lib = load_ingest_library()
    num_frames = len(frame_labels)
    labels: List[np.ndarray] = [np.asarray(l).reshape(-1) for l in frame_labels]
    labels_cat = np.ascontiguousarray(
        np.concatenate(labels) if num_frames else np.zeros(0), dtype=np.int64)
    boxes_cat = np.ascontiguousarray(
        np.concatenate([np.asarray(b, np.float32).reshape(-1, 4) for b in frame_boxes])
        if labels_cat.size else np.zeros((0, 4)), dtype=np.float32)
    if len(boxes_cat) != labels_cat.size:
        raise ValueError(f"{len(boxes_cat)} boxes for {labels_cat.size} labels")
    if labels_cat.size and (labels_cat.min() < 0 or labels_cat.max() >= len(is_cone)):
        raise ValueError(f"class ids outside [0, {len(is_cone)}): "
                         f"{labels_cat.min()}..{labels_cat.max()}")
    offsets = np.zeros(num_frames + 1, np.int64)
    offsets[1:] = np.cumsum([len(l) for l in labels])
    out = np.zeros((num_frames, 15, feature_width), np.float32)
    cone_table = np.ascontiguousarray(is_cone, dtype=np.uint8)
    lib.pad_video(_ptr(boxes_cat, ctypes.c_float), _ptr(labels_cat, ctypes.c_int64),
                  _ptr(offsets, ctypes.c_int64), num_frames, feature_width,
                  _ptr(cone_table, ctypes.c_uint8), _ptr(out, ctypes.c_float))
    return out


def native_containment_oracle(padded: np.ndarray, feature_width: int) -> np.ndarray:
    """`data/ingest.py::containment_oracle` in C++: the slot carrying the
    snitch signal per frame, `(T,)` int32."""
    lib = load_ingest_library()
    padded = np.ascontiguousarray(padded, np.float32)
    if padded.ndim != 3 or padded.shape[1:] != (15, feature_width):
        raise ValueError(f"padded must be (T, 15, {feature_width}), not {padded.shape}")
    out = np.zeros(len(padded), np.int32)
    lib.containment_oracle(_ptr(padded, ctypes.c_float), len(padded), feature_width,
                           int(feature_width == 6), _ptr(out, ctypes.c_int32))
    return out
