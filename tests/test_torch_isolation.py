"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points run on the card unless asked for the CPU.

Each check runs in a fresh interpreter where `import jax` (and orbax, cv2,
which only `read_video_frames` imports, at its first call, and PIL, which
only `DetectionDataset.load_image` imports) is made to fail, so such an
import anywhere in the port would break it.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PRELUDE = """
import sys
sys.modules["jax"] = None
sys.modules["orbax"] = None
sys.modules["cv2"] = None
sys.modules["PIL"] = None
sys.path.insert(0, {repo!r})
"""


def _run(body: str, tmp_path) -> str:
    """`body` in a fresh interpreter, on one CPU thread: with more, torch's
    thread pool stalls when the lane's workers share the cores."""
    code = _PRELUDE.format(repo=str(REPO)) + textwrap.dedent(body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_every_port_module_imports_without_jax(tmp_path):
    out = _run("""
        import importlib, pkgutil
        import objectpermanence_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m == "objectpermanence_tpu" or m.startswith("objectpermanence_tpu."))
        assert not leaked, leaked
        assert sys.modules["jax"] is None
        print(len(names))
    """, tmp_path)
    assert int(out.split()[-1]) >= 15


def test_cpu_path_runs_without_jax(tmp_path):
    out = _run("""
        import json
        from pathlib import Path
        from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
        from objectpermanence_tpu_torch.infer.reasoning import reasoning_inference_main
        pred, labels, _ = write_fixture_dataset("data", num_videos=3, seed=1, num_frames=40)
        config = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
                  "videos_hidden_dim": 24}
        preds = reasoning_inference_main(
            "opnet", "out", {"sample_dir": str(pred), "labels_dir": str(labels),
                             "device": "cpu"}, config)
        assert sorted(p.name for p in Path("out").glob("*_bb.json")) == [
            f"CATER_fixture_{i:06d}_bb.json" for i in range(3)]
        assert all(v.shape == (40, 4) for v in preds.values())
        from objectpermanence_tpu_torch.data.ingest import ingest_directory
        from objectpermanence_tpu_torch.models.registry import get_model_spec
        from objectpermanence_tpu_torch.train.loop import training_main
        data = ingest_directory(pred, labels, 6, "data/containment_annotations.txt")
        paths = {k: "x" for k in ("train_sample_dir", "train_labels_dir",
                                  "train_containment_file", "dev_sample_dir",
                                  "dev_labels_dir", "dev_containment_file")}
        result = training_main(get_model_spec("opnet_att_ce"), data, data,
                               {**paths, "device": "cpu", "num_epochs": 1, "batch_size": 2,
                                "checkpoints_path": "ckpt"}, config)
        assert [h["epoch"] for h in result.history] == [1]
        leaked = [m for m in sys.modules if m.startswith("objectpermanence_tpu.")]
        assert not leaked, leaked
        print("ok")
    """, tmp_path)
    assert out.strip().endswith("ok")


def test_entry_points_raise_without_a_card(tmp_path):
    shipped = str(REPO / "configs" / "preprocess_config.json")
    out = _run("""
        import json
        import torch
        assert not torch.cuda.is_available()
        from objectpermanence_tpu_torch.infer.reasoning import (
            make_predict_step, reasoning_inference_main)
        from objectpermanence_tpu_torch.models.registry import get_model_spec, init_model
        spec = get_model_spec("opnet")
        config = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
                  "videos_hidden_dim": 24}
        from objectpermanence_tpu_torch.__main__ import main as cli_main
        from objectpermanence_tpu_torch.train.loop import training_main
        from objectpermanence_tpu_torch.infer.preprocess import preprocess_main
        from objectpermanence_tpu_torch.models.detector import CaterDetector
        from objectpermanence_tpu_torch.models.detector.detector import DetectorConfig
        from objectpermanence_tpu_torch.train.detector_loop import train_detector
        from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
        from objectpermanence_tpu_torch.data.fixtures import write_detection_fixture
        det_data = DetectionDataset(*write_detection_fixture("det", 1, 1)[:2])
        with open("preprocess.json", "w") as f:  # the shipped config: the card
            json.dump(json.load(open({shipped!r})), f)
        training = {k: "x" for k in ("train_sample_dir", "train_labels_dir",
                                     "train_containment_file", "dev_sample_dir",
                                     "dev_labels_dir", "dev_containment_file")}
        training["device"] = "tpu"
        with open("training.json", "w") as f:
            json.dump(training, f)
        with open("model.json", "w") as f:
            json.dump(config, f)
        calls = [lambda: make_predict_step(spec),
                 lambda: init_model("opnet", config),
                 lambda: init_model("opnet", config, train=True),
                 lambda: reasoning_inference_main(
                     "opnet", "out", {"sample_dir": "s", "labels_dir": "l",
                                      "device": "tpu"}, config),
                 lambda: training_main(spec, None, None, training, config),
                 lambda: cli_main(["training", "--model_type", "opnet", "--model_config",
                                   "model.json", "--training_config", "training.json"]),
                 lambda: CaterDetector(),
                 lambda: preprocess_main("out", {"videos_dir": "v"}),
                 lambda: cli_main(["preprocess", "--results_dir", "out", "--config",
                                   "preprocess.json"]),
                 lambda: train_detector(det_data, None, DetectorConfig()),
                 lambda: train_detector(det_data, None, DetectorConfig(), device="cuda")]
        for call in calls:
            try:
                call()
            except RuntimeError as exc:
                assert "no CUDA device" in str(exc), exc
            else:
                raise AssertionError("ran without a card")
        print("ok")
    """.replace("{shipped!r}", repr(shipped)), tmp_path)
    assert out.strip().endswith("ok")


def test_preprocess_cpu_path_runs_without_jax_or_cv2(tmp_path):
    out = _run("""
        import pickle
        from pathlib import Path
        import numpy as np
        from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
        from objectpermanence_tpu_torch.infer import preprocess
        Path("videos").mkdir()
        for name in ("CATER_new_000001", "CATER_new_000002"):
            (Path("videos") / f"{name}.avi").touch()
        preprocess.read_video_frames = lambda path: draw_frames(
            make_scene(int(Path(path).stem[-1]), num_frames=300))[:, ::4, ::4]
        config = {"videos_dir": "videos", "batch_size": 150, "device": "cpu",
                  "image_hw": [60, 80], "min_size": 64, "max_size": 96,
                  "backbone_layers": [1, 1, 1, 1], "backbone_width": 8,
                  "fpn_channels": 16, "rpn_pre_nms_top_n": 50, "rpn_post_nms_top_n": 20,
                  "detections_per_img": 5}
        written = preprocess.preprocess_main("out", config)
        assert written == ["CATER_new_000001", "CATER_new_000002"], written
        data = pickle.load(open("out/CATER_new_000001.pkl", "rb"))
        assert set(data) == {"bb", "labels"} and len(data["bb"]) == 300
        assert all(b.dtype == np.float32 and b.shape[1:] == (4,) for b in data["bb"])
        assert sys.modules["cv2"] is None and sys.modules["jax"] is None
        leaked = [m for m in sys.modules if m.startswith("objectpermanence_tpu.")]
        assert not leaked, leaked
        print("ok")
    """, tmp_path)
    assert out.strip().endswith("ok")


def test_detector_training_cpu_path_runs_without_jax_or_pil(tmp_path):
    out = _run("""
        from pathlib import Path
        import numpy as np
        from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
        from objectpermanence_tpu_torch.data.fixtures import write_detection_fixture
        from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
        from objectpermanence_tpu_torch.train.detector_loop import evaluate_detector, train_detector
        images_dir, csv_path, frames = write_detection_fixture("det", 3, 2, seed=1)
        data = DetectionDataset(images_dir, csv_path)
        data.load_image = frames.__getitem__   # no PIL: the drawn frames themselves
        config = DetectorConfig(min_size=240, max_size=320, backbone_layers=(1, 1, 1, 1),
                                backbone_width=8, fpn_channels=16, rpn_pre_nms_top_n=50,
                                rpn_post_nms_top_n=20, detections_per_img=5,
                                backbone_norm="group")
        result = train_detector(data, data, config, num_epochs=1, batch_size=4,
                                checkpoint_dir="ckpt", device="cpu")
        assert [h["epoch"] for h in result["history"]] == [1]
        assert np.isfinite(result["history"][0]["train_loss"])
        assert Path("ckpt/final.npz").exists() and Path("ckpt/resume/epoch_0001").is_dir()
        metrics = evaluate_detector(CaterDetector.load("ckpt/final.npz", config, device="cpu"),
                                    data)
        assert set(metrics) == {"mAP", "AP50", "AP75"}
        assert sys.modules["PIL"] is None and sys.modules["jax"] is None
        leaked = [m for m in sys.modules if m.startswith("objectpermanence_tpu.")]
        assert not leaked, leaked
        print("ok")
    """, tmp_path)
    assert out.strip().endswith("ok")


def test_800px_windowed_bf16_path_runs_without_jax(tmp_path):
    out = _run("""
        import numpy as np
        import torch
        from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
        from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
        from objectpermanence_tpu_torch.ops import roi_align_window
        config = DetectorConfig(backbone_layers=(1, 1, 1, 1), backbone_width=8, fpn_channels=16,
                                rpn_pre_nms_top_n=50, rpn_post_nms_top_n=20,
                                detections_per_img=5, backbone_norm="group",
                                roi_backend="windowed", compute_dtype="bfloat16")
        assert config.padded_hw == (800, 1088)
        boxes, labels, scores, valid = CaterDetector(config, device="cpu")(
            draw_frames(make_scene(1, num_frames=2)))
        assert boxes.dtype == np.float32 and boxes.shape == (2, 5, 4)
        assert roi_align_window.contract_stats()["rois"] == 40
        assert sys.modules["jax"] is None
        leaked = [m for m in sys.modules if m.startswith("objectpermanence_tpu.")]
        assert not leaked, leaked
        print("ok")
    """, tmp_path)
    assert out.strip().endswith("ok")
