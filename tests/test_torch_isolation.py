"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points run on the card unless asked for the CPU.

Each check runs in a fresh interpreter where `import jax` (and orbax) is
made to fail, so an import anywhere in the port would break it.
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
sys.path.insert(0, {repo!r})
"""


def _run(body: str, tmp_path) -> str:
    code = _PRELUDE.format(repo=str(REPO)) + textwrap.dedent(body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
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
                                   "model.json", "--training_config", "training.json"])]
        for call in calls:
            try:
                call()
            except RuntimeError as exc:
                assert "no CUDA device" in str(exc), exc
            else:
                raise AssertionError("ran without a card")
        print("ok")
    """, tmp_path)
    assert out.strip().endswith("ok")
