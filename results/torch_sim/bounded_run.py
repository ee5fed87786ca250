"""The bounded headline run of the PyTorch/CUDA port on one CUDA card: the
fair-budget learned-model comparison of `STATUS.md` through the port's
experiment drivers, each stage as the process a user would start.

    python3 results/torch_sim/bounded_run.py [--root build/torch_sim] [--out results/torch_sim]

1. `containment_run datagen`: 800 train / 200 dev / 300 test simulated
   scenes (300 frames, 8 objects, the driver's default planner and seeds);
2. `variant_sweep --train-limit 800 --epochs 160 --models opnet
   baseline_lstm transformer_lstm`: the reference recipe, then inference
   and the analyzer on the test split;
3. `cater_grid_run --models opnet`: the 6x6 grid accuracy of the test split.

Writes to `--out`: the sweep's `results.json`, `grid_results.json`,
`metrics.jsonl` (every epoch of every model, its name under "model") and
`run.json`: the card's name and power limit as `nvidia-smi` gives them, each
stage's wall seconds, and each model's dev mIoU over its last 10 epochs (the
run's own spread). Needs the card; imports nothing of JAX.
"""

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
MODELS = ("opnet", "baseline_lstm", "transformer_lstm")
SPLITS = {"train": 800, "dev": 200, "test": 300}
EPOCHS, SPREAD_EPOCHS = 160, 10


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def stage(seconds, name, driver, *argv):
    command = [sys.executable, "-m", f"objectpermanence_tpu_torch.experiments.{driver}",
               *map(str, argv)]
    print(f"[bounded] {name}: {' '.join(command[1:])}", flush=True)
    t0 = time.perf_counter()
    subprocess.run(command, check=True, cwd=REPO)
    seconds[name] = round(time.perf_counter() - t0, 3)
    print(f"[bounded] {name}: {seconds[name]} s", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO / "build" / "torch_sim")
    ap.add_argument("--out", type=Path, default=REPO / "results" / "torch_sim")
    args = ap.parse_args(argv)
    root, out = args.root.resolve(), args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    smi = card()
    print(smi, flush=True)

    seconds = {}
    stage(seconds, "datagen", "containment_run", "datagen", "--root", root,
          "--train-videos", SPLITS["train"], "--dev-videos", SPLITS["dev"],
          "--test-videos", SPLITS["test"])
    stage(seconds, "variant_sweep", "variant_sweep", "--root", root, "--train-limit",
          SPLITS["train"], "--epochs", EPOCHS, "--models", *MODELS)
    stage(seconds, "cater_grid_run", "cater_grid_run", "--root", root, "--models", "opnet")

    shutil.copy(root / "sweep" / "results.json", out / "results.json")
    shutil.copy(root / "cater" / "grid_results.json", out / "grid_results.json")
    spread = {}
    with open(out / "metrics.jsonl", "w") as f:
        for model in MODELS:
            epochs = [json.loads(line) for line in
                      (root / "sweep" / model / "metrics.jsonl").read_text().splitlines()]
            for e in epochs:
                f.write(json.dumps({"model": model, **e}) + "\n")
            last = np.array([e["dev"]["mean_iou"] for e in epochs[-SPREAD_EPOCHS:]])
            spread[model] = {"epochs": len(epochs), "dev_miou_last": last.tolist(),
                             "min": float(last.min()), "max": float(last.max()),
                             "std": float(last.std()),
                             "epoch_seconds_mean": float(np.mean(
                                 [e["epoch_seconds"] for e in epochs]))}
    run = {"card": smi, "card_at_end": card(), "splits": SPLITS, "epochs": EPOCHS,
           "stage_seconds": seconds,
           "train_seconds": {r["model"]: r["train_seconds"] for r in
                             json.loads((out / "results.json").read_text())},
           "dev_miou_last_epochs": spread}
    (out / "run.json").write_text(json.dumps(run, indent=2) + "\n")
    print(json.dumps(run), flush=True)


if __name__ == "__main__":
    main()
