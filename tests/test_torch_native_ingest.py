"""The port's native ingest (`native/ingest.cc`, `native/build.py`) on the
CPU: its library against the port's Python path and against the JAX
package's library and Python path, bit for bit, on fixture scenes at both
feature widths and on empty frames with duplicate detections; a directory
ingested both ways; a failed build raises, with no fallback."""

import numpy as np
import pytest

from objectpermanence_tpu.data import ingest as jax_ingest
from objectpermanence_tpu.data.fixtures import make_scene
from objectpermanence_tpu.native.build import native_containment_oracle as jax_native_oracle
from objectpermanence_tpu.native.build import native_pad_video as jax_native_pad
from objectpermanence_tpu_torch.data import ingest
from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
from objectpermanence_tpu_torch.native import build
from objectpermanence_tpu_torch.vocab import IS_CONE


def _scene_to_raw(scene):
    boxes, classes, visible = scene["boxes"], scene["classes"], scene["visible"]
    frame_bbs, frame_labels = [], []
    for f in range(len(boxes)):
        mask = visible[f]
        frame_bbs.append(boxes[f, mask].astype(np.float32))
        frame_labels.append(classes[mask].astype(np.int64))
    return frame_bbs, frame_labels


def _all_four(bbs, labels, feature_width):
    """(padded, track) of the port's library, its Python path, JAX's
    library and JAX's Python path."""
    padded = [build.native_pad_video(bbs, labels, feature_width, IS_CONE),
              ingest.pad_video_detections(bbs, labels, feature_width),
              jax_native_pad(bbs, labels, feature_width, IS_CONE),
              jax_ingest.pad_video_detections(bbs, labels, feature_width)]
    tracks = [build.native_containment_oracle(padded[0], feature_width),
              ingest.containment_oracle(padded[1], feature_width),
              jax_native_oracle(padded[2], feature_width),
              jax_ingest.containment_oracle(padded[3], feature_width)]
    return padded, tracks


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("feature_width", [5, 6])
def test_native_matches_python_and_jax_bitwise(feature_width, seed):
    bbs, labels = _scene_to_raw(make_scene(seed=seed, num_frames=80, num_objects=7))
    padded, tracks = _all_four(bbs, labels, feature_width)
    for other in padded[1:]:
        assert other.dtype == padded[0].dtype == np.float32
        np.testing.assert_array_equal(padded[0], other)
    for other in tracks[1:]:
        assert other.dtype == tracks[0].dtype == np.int32
        np.testing.assert_array_equal(tracks[0], other)
    assert (tracks[0] != 0).any()  # the snitch signal moved to a carrier


@pytest.mark.parametrize("feature_width", [5, 6])
def test_native_empty_frames_and_duplicates(feature_width):
    bbs = [np.array([[10, 10, 20, 20], [11, 11, 21, 21]], np.float32),
           np.zeros((0, 4), np.float32),
           np.array([[30, 30, 40, 40]], np.float32)]
    labels = [np.array([7, 7]), np.zeros(0, np.int64), np.array([0])]
    padded, tracks = _all_four(bbs, labels, feature_width)
    for other in padded[1:]:
        np.testing.assert_array_equal(padded[0], other)
    for other in tracks[1:]:
        np.testing.assert_array_equal(tracks[0], other)
    assert padded[0][1].sum() == 0 and padded[0][0, 1, 0] == np.float32(10 / 320)


def test_ingest_directory_native_and_python_equal(tmp_path, monkeypatch):
    pred, labels, cont = write_fixture_dataset(tmp_path / "data", num_videos=3, seed=4,
                                               num_frames=40)
    native = ingest.ingest_directory(pred, labels, 6, cont, native=True)
    python = ingest.ingest_directory(pred, labels, 6, cont, native=False)
    monkeypatch.setenv("OP_TPU_DISABLE_NATIVE", "1")
    switched = ingest.ingest_directory(pred, labels, 6, cont)
    for other in (python, switched):
        assert other.names == native.names
        for key in ("boxes", "index_to_track", "labels", "containment_mask"):
            np.testing.assert_array_equal(getattr(native, key), getattr(other, key), err_msg=key)


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    pred, labels, _ = write_fixture_dataset(tmp_path / "data", num_videos=1, seed=5,
                                            num_frames=10)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(build, "COMPILER", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="native ingest build failed"):
        ingest.ingest_directory(pred, labels, 6)
    assert not list((tmp_path / "native").glob("*.so"))
    # the Python path runs only where it is asked for
    assert len(ingest.ingest_directory(pred, labels, 6, native=False)) == 1


def test_build_is_cached_by_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    path = build.build()
    assert path.parent == tmp_path / "native" and path.name.startswith("libingest_")
    stamp = path.stat().st_mtime_ns
    assert build.build() == path and path.stat().st_mtime_ns == stamp


def test_native_rejects_what_it_cannot_read():
    bbs, labels = [np.zeros((1, 4), np.float32)], [np.array([len(IS_CONE)])]
    with pytest.raises(ValueError, match="class ids"):
        build.native_pad_video(bbs, labels, 6, IS_CONE)
    with pytest.raises(ValueError, match="feature_width"):
        build.native_pad_video(bbs, [np.array([3])], 4, IS_CONE)
    with pytest.raises(ValueError, match="padded"):
        build.native_containment_oracle(np.zeros((3, 15, 5), np.float32), 6)
