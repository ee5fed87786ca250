"""`torchrun --nproc_per_node 2 -m objectpermanence_tpu_torch training` on the
CPU (two gloo ranks, `--standalone`: a free local port) against the same
run in one process without a launcher: the same epochs and metrics (losses
within rtol 1e-5, mean IoUs within 1e-3), one metrics line per epoch and
one set of checkpoints, and the last epoch's params within 1e-5 wherever
Adam's root-mean-square gradient (from its second moment) is at least 1e-7;
below that, Adam magnifies the rounding of a sum in another order
(`tests/test_torch_train.py`)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from objectpermanence_tpu_torch.__main__ import main as port_main
from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset

REPO = Path(__file__).resolve().parent.parent
NARROW = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
          "videos_hidden_dim": 24}
FRAMES, EPOCHS = 20, 2


def _config(root, tag, splits):
    (train_pred, train_labels, train_cont), (dev_pred, dev_labels, dev_cont) = splits
    config = {"batch_size": 6, "inference_batch_size": 8, "num_epochs": EPOCHS,
              "print_step": 1, "learning_rate": 1e-3, "device": "cpu",
              "checkpoints_path": str(root / tag / "ckpt"), "cache_dir": str(root / "cache"),
              "metrics_file": str(root / tag / "metrics.jsonl"),
              "train_sample_dir": str(train_pred), "train_labels_dir": str(train_labels),
              "train_containment_file": str(train_cont), "dev_sample_dir": str(dev_pred),
              "dev_labels_dir": str(dev_labels), "dev_containment_file": str(dev_cont)}
    (root / tag).mkdir()
    path = root / tag / "training.json"
    path.write_text(json.dumps(config))
    return path


def _state(path):
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


def test_torchrun_training_equals_one_process(tmp_path):
    splits = (write_fixture_dataset(tmp_path / "train", num_videos=11, seed=2, num_frames=FRAMES),
              write_fixture_dataset(tmp_path / "dev", num_videos=5, seed=3, num_frames=FRAMES))
    (tmp_path / "model.json").write_text(json.dumps(NARROW))
    args = ["training", "--model_type", "opnet", "--model_config", str(tmp_path / "model.json"),
            "--training_config"]
    launched = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "objectpermanence_tpu_torch", *args, str(_config(tmp_path, "world2", splits))],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert launched.returncode == 0, launched.stdout[-3000:] + launched.stderr[-3000:]
    assert port_main(args + [str(_config(tmp_path, "world1", splits))]) == 0

    runs = {}
    for tag in ("world1", "world2"):
        lines = (tmp_path / tag / "metrics.jsonl").read_text().splitlines()
        tree = tmp_path / tag / "ckpt" / "opnet"
        runs[tag] = ([json.loads(line) for line in lines], sorted(p.name for p in tree.glob("*.npz")),
                     _state(tree / "resume" / f"epoch_{EPOCHS:04d}" / "state.npz"))
    (one, one_best, one_state), (two, two_best, two_state) = runs["world1"], runs["world2"]
    assert [e["epoch"] for e in two] == [e["epoch"] for e in one] == [1, 2]
    assert two_best and len(two_best) == len(one_best)
    for ours, theirs in zip(two, one):
        assert ours["learning_rate"] == theirs["learning_rate"]
        for split in ("train", "dev"):
            np.testing.assert_allclose(ours[split]["loss"], theirs[split]["loss"], rtol=1e-5)
            for key in ("mean_iou", "containment_mean_iou"):
                np.testing.assert_allclose(ours[split][key], theirs[split][key], atol=1e-3)
    assert set(two_state) == set(one_state)
    steps = float(one_state[next(k for k in one_state if k.startswith("step/"))])
    for key in (k for k in one_state if k.startswith("params/")):
        name = key[len("params/"):]
        rms = np.sqrt(one_state[f"exp_avg_sq/{name}"] / (1 - 0.999 ** steps))
        conditioned = rms >= 1e-7
        assert conditioned.any(), name
        np.testing.assert_allclose(two_state[key][conditioned], one_state[key][conditioned],
                                   rtol=0, atol=1e-5, err_msg=name)
