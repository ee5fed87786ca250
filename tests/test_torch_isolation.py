"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points run on the card unless asked for the CPU.

Each check runs in a fresh interpreter where `import jax` (and orbax, cv2,
which only the functions that decode, draw or write video import, at their
first call, and PIL, which only `DetectionDataset.load_image` imports) is
made to fail, so such an import anywhere in the port would break it.
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


def test_model_parallel_modules_import_without_jax(tmp_path):
    """The model-parallel half of `parallel/` and the dry run import in an
    interpreter without JAX, and the dry run asked for the card raises."""
    out = _run("""
        import importlib
        for name in ("sharding", "sequence", "pipeline", "expert", "dryrun"):
            importlib.import_module(f"objectpermanence_tpu_torch.parallel.{name}")
        from objectpermanence_tpu_torch.parallel.dryrun import dryrun_multichip
        try:
            dryrun_multichip(2)
        except RuntimeError as exc:
            assert "no CUDA device" in str(exc), exc
        else:
            raise AssertionError("ran without a card")
        leaked = sorted(m for m in sys.modules
                        if m == "objectpermanence_tpu" or m.startswith("objectpermanence_tpu."))
        assert not leaked, leaked
        assert sys.modules["jax"] is None
        print("ok")
    """, tmp_path)
    assert out.strip().endswith("ok")


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


def test_root_scripts_and_new_cli_modes_run_without_jax(tmp_path):
    out = _run("""
        import importlib.util, json
        from pathlib import Path
        for script in ("chip_smoke.py", "bench_torch.py"):
            spec = importlib.util.spec_from_file_location(script[:-3], Path({repo!r}) / script)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        from objectpermanence_tpu_torch.__main__ import main as cli_main
        from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
        pred, labels, containment = write_fixture_dataset("data", num_videos=3, seed=1,
                                                          num_frames=40)
        json.dump({"videos_hidden_dim": 8, "boxes_features_dim": 4}, open("model.json", "w"))
        json.dump({"sample_dir": str(pred), "labels_dir": str(labels), "device": "cpu"},
                  open("inference.json", "w"))
        for mode in ("inference", "cater_inference"):
            assert cli_main([mode, "--model_type", "non_linear_lstm", "--results_dir", "out",
                             "--inference_config", "inference.json",
                             "--model_config", "model.json"]) == 0
        assert cli_main(["analysis", "--predictions_dir", "out", "--labels_dir", str(labels),
                         "--containment_annotations", str(containment), "--iou_thresholds",
                         "0.5", "--output_file", "analysis.csv"]) == 0
        assert Path("out/class_pred_results.csv").exists() and Path("analysis.csv").exists()
        assert sys.modules["jax"] is None
        leaked = [m for m in sys.modules if m.startswith("objectpermanence_tpu.")]
        assert not leaked, leaked
        print("ok")
    """.replace("{repo!r}", repr(str(REPO))), tmp_path)
    assert out.strip().endswith("ok")


def test_datagen_native_ingest_and_launched_training_run_without_jax(tmp_path):
    """Simulated scenes, perfect perception and annotations (no cv2, no
    PIL), then the training CLI as one rank of a launcher at world 1 (gloo):
    the mesh, DDP and the native ingest."""
    out = _run("""
        import json, os
        from pathlib import Path
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                          MASTER_PORT="0")
        import torch.distributed as dist
        from objectpermanence_tpu_torch.__main__ import main as cli_main
        from objectpermanence_tpu_torch.datagen.perfect_perception import (
            PerfectPerceptionGenerator,
        )
        from objectpermanence_tpu_torch.datagen.scene_labels import write_annotation_files
        from objectpermanence_tpu_torch.datagen.simulator import simulate_dataset
        scenes, labels = simulate_dataset("sim", num_videos=3, seed=1, num_frames=30)
        PerfectPerceptionGenerator(scenes, labels, "perception").generate()
        ann = write_annotation_files(scenes, "ann")
        paths = {f"{split}_{key}": value for split in ("train", "dev") for key, value in (
            ("sample_dir", "perception"), ("labels_dir", str(labels)),
            ("containment_file", str(ann["containment"])))}
        json.dump({**paths, "device": "cpu", "num_epochs": 1, "batch_size": 2,
                   "checkpoints_path": "ckpt", "cache_dir": "cache"}, open("train.json", "w"))
        json.dump({"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 8,
                   "videos_hidden_dim": 8}, open("model.json", "w"))
        assert cli_main(["training", "--model_type", "opnet", "--model_config", "model.json",
                         "--training_config", "train.json"]) == 0
        assert not dist.is_initialized()
        assert (Path("ckpt") / "opnet" / "resume" / "epoch_0001" / "state.npz").exists()
        assert len(list(Path("cache").glob("ingest_*.npz"))) == 1
        assert sys.modules["jax"] is None
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
        with open("tracker.json", "w") as f:   # no "device": the card
            json.dump({"sample_dir": "s"}, f)
        from objectpermanence_tpu_torch.infer.trackers import trackers_inference_main
        from objectpermanence_tpu_torch.models.siam import SiamRPNTracker
        from objectpermanence_tpu_torch.train.siam_loop import siam_train_main
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
                 lambda: train_detector(det_data, None, DetectorConfig(), device="cuda"),
                 lambda: trackers_inference_main("detector_tracker", "out", {"sample_dir": "s"}),
                 lambda: cli_main(["inference", "--model_type", "detector_tracker",
                                   "--results_dir", "out", "--inference_config",
                                   "tracker.json"]),
                 lambda: SiamRPNTracker(),
                 lambda: siam_train_main("pairs.npz", "ckpt")]
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


def test_trackers_run_without_jax_or_cv2(tmp_path):
    """The heuristic through the CLI, and detector_tracker on the CPU with
    its frame reader and debug writer replaced (as on a machine without
    cv2), and `siam_train_main` on pairs that `_crop_pair` cuts, all with
    jax, orbax and cv2 failing to import."""
    out = _run("""
        import json
        from pathlib import Path
        import numpy as np
        from objectpermanence_tpu_torch.__main__ import main as cli_main
        from objectpermanence_tpu_torch.data.fixtures import (
            draw_frames, make_scene, write_fixture_dataset)
        from objectpermanence_tpu_torch.infer import trackers
        from objectpermanence_tpu_torch.train import siam_loop
        pred, labels, _ = write_fixture_dataset("data", num_videos=2, seed=4, num_frames=30)
        json.dump({"sample_dir": str(pred), "labels_dir": str(labels)}, open("h.json", "w"))
        assert cli_main(["inference", "--model_type", "detector_heuristic", "--results_dir",
                         "heuristic", "--inference_config", "h.json"]) == 0
        assert len(json.loads(Path("heuristic/CATER_fixture_000001_bb.json").read_text())) == 30
        Path("videos").mkdir()
        for name in ("CATER_fixture_000000", "CATER_fixture_000001"):
            (Path("videos") / f"{name}.avi").touch()
        trackers.read_video_bgr = lambda path: draw_frames(
            make_scene(4000 + int(Path(path).stem[-1]), num_frames=30))[..., ::-1]
        trackers.open_debug_writer = lambda path, width, height: None
        boxes = trackers.trackers_inference_main(
            "detector_tracker", "tracked", {"sample_dir": str(pred), "videos_dir": "videos",
                                            "device": "cpu"})
        assert sorted(boxes) == ["CATER_fixture_000000", "CATER_fixture_000001"]
        assert all(len(v) == 30 for v in boxes.values())
        frames = draw_frames(make_scene(1, num_frames=4))
        rng = np.random.RandomState(0)
        pairs = [siam_loop._crop_pair([frames[0], frames[2]], (100, 80, 20, 16),
                                      (104, 82, 20, 16), rng) for _ in range(3)]
        np.savez("pairs.npz", z=np.stack([p[0] for p in pairs]),
                 x=np.stack([p[1] for p in pairs]), gt=np.stack([p[2] for p in pairs]))
        result = siam_loop.siam_train_main("pairs.npz", "ckpt", num_epochs=2, batch_size=2,
                                           holdout=1, device="cpu")
        assert Path(result["checkpoint"]).exists() and len(result["history"]) == 2
        assert sys.modules["cv2"] is None and sys.modules["jax"] is None
        leaked = [m for m in sys.modules if m.startswith("objectpermanence_tpu.")]
        assert not leaked, leaked
        print("ok")
    """, tmp_path)
    assert out.strip().endswith("ok")
