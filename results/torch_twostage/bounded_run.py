"""The bounded REAL two-stage run of the PyTorch/CUDA port on one CUDA card:
pixels -> Faster R-CNN -> OPNet through the port's experiment drivers, the
counterpart of `results/twostage800/` (the JAX package's run).

    python3 results/torch_twostage/bounded_run.py [--root build/torch_twostage] [--out results/torch_twostage]

1. `containment_run datagen`: 300 train / 100 dev / 200 test simulated
   scenes (300 frames, 8 objects, the driver's default planner and seeds);
2. `two_stage_run render --det-samples 8`, then `all` (dettrain: the
   GroupNorm ResNet-50 FPN at 240 x 320, RPN 500/300, batch 8, lr 5e-3, 16
   epochs; preprocess: every video; opnet: OPNet 256/512, the reference
   recipe, 160 epochs; analyze);
3. `two_stage_run opnet` then `analyze` with `--model baseline_lstm` and
   `--model transformer_lstm` on the same detections.

Each stage runs through its driver's `main()` in this process, so that the
port's kernel wrappers' launch counts can be read around it. Writes to
`--out`: `detector_report.json`, `perception_stats.json`, `analysis*.csv`,
`opnet_train_metrics.jsonl`, `results_models.json` (the analysis rows'
means, JAX's `results_models.json` keys) and `run.json`: the card's name
and power limit as `nvidia-smi` gives them, each stage's wall seconds and
launches by kernel. Needs the card; imports nothing of JAX.
"""

import argparse
import csv
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

SPLITS = {"train": 300, "dev": 100, "test": 200}
DET_SAMPLES, DET_EPOCHS, EPOCHS = 8, 16, 160
OTHER_MODELS = ("baseline_lstm", "transformer_lstm")


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def launch_counters():
    """The port's kernel wrappers by kernel, whose `launches` each adds to."""
    from objectpermanence_tpu_torch.ops.lstm_scan import (
        lstm_scan_backward, lstm_scan_forward, lstm_scan_hs,
    )
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_fused_forward
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched, roi_align_batched_backward, roi_align_windowed,
    )
    return {"K1": opnet_fused_forward, "K2": lstm_scan_forward, "K3": lstm_scan_backward,
            "K4": lstm_scan_hs, "K7": roi_align_batched, "K8": roi_align_batched_backward,
            "K9": roi_align_windowed}


def stage(record, name, main, *argv):
    """`main(argv)` of a driver, its wall seconds and launches recorded."""
    import torch
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    argv = [str(a) for a in argv]
    print(f"[bounded] {name}: {' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    main(argv)
    torch.cuda.synchronize()
    record[name] = {"seconds": round(time.perf_counter() - t0, 3),
                    "launches": {k: fn.launches for k, fn in counters.items() if fn.launches}}
    print(f"[bounded] {name}: {record[name]}", flush=True)


def analysis_row(path, model):
    """The means over the test videos of an analysis CSV, as JAX's
    `results_models.json` rows."""
    with open(path) as f:
        rows = list(csv.DictReader(f))

    def mean(column):
        values = [float(r[column]) for r in rows if r[column] not in ("", "nan")]
        return round(sum(values) / len(values), 4) if values else None

    return {"model": model, "videos": len(rows), "overall_iou": mean("overall_iou"),
            "contained_iou": mean("contained_mean_iou"),
            "full_occlusion_iou": mean("full_occlusion_mean_iou"),
            "visible_iou": mean("visibility_gt_0_mean_iou"), "map_0.5": mean("overall_map_0.5")}


def main(argv=None) -> None:
    from objectpermanence_tpu_torch.experiments import containment_run, two_stage_run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO / "build" / "torch_twostage")
    ap.add_argument("--out", type=Path, default=REPO / "results" / "torch_twostage")
    args = ap.parse_args(argv)
    root, out = args.root.resolve(), args.out.resolve()
    src, ts = root / "src", root / "twostage"
    out.mkdir(parents=True, exist_ok=True)
    smi = card()
    print(smi, flush=True)

    stages = {}
    stage(stages, "datagen", containment_run.main, "datagen", "--root", src,
          "--train-videos", SPLITS["train"], "--dev-videos", SPLITS["dev"],
          "--test-videos", SPLITS["test"])
    common = ["--root", ts, "--src", src]
    stage(stages, "render", two_stage_run.main, "render", *common, "--det-samples", DET_SAMPLES)
    stage(stages, "dettrain", two_stage_run.main, "dettrain", *common,
          "--det-epochs", DET_EPOCHS)
    stage(stages, "preprocess", two_stage_run.main, "preprocess", *common)
    stage(stages, "opnet", two_stage_run.main, "opnet", *common, "--epochs", EPOCHS)
    stage(stages, "analyze", two_stage_run.main, "analyze", *common)
    for model in OTHER_MODELS:
        stage(stages, f"opnet_{model}", two_stage_run.main, "opnet", *common,
              "--epochs", EPOCHS, "--model", model)
        stage(stages, f"analyze_{model}", two_stage_run.main, "analyze", *common,
              "--model", model)

    report = json.loads((ts / "detector" / "report.json").read_text())
    for epoch in report["history"]:
        epoch.pop("train_losses", None)     # per-step losses: thousands of lines
    (out / "detector_report.json").write_text(json.dumps(report, indent=2) + "\n")
    shutil.copy(ts / "perception_stats.json", out / "perception_stats.json")
    shutil.copy(ts / "metrics.jsonl", out / "opnet_train_metrics.jsonl")
    rows = []
    for model in ("opnet", *OTHER_MODELS):
        suffix = "" if model == "opnet" else f"_{model}"
        shutil.copy(ts / f"analysis{suffix}.csv", out / f"analysis{suffix}.csv")
        rows.append(analysis_row(ts / f"analysis{suffix}.csv", model))
    (out / "results_models.json").write_text(json.dumps(rows, indent=2) + "\n")
    run = {"card": smi, "card_at_end": card(), "splits": SPLITS, "det_samples": DET_SAMPLES,
           "det_epochs": DET_EPOCHS, "epochs": EPOCHS, "stages": stages,
           "detector_test": report["test"], "detector_best_dev_map": report["best_dev_map"],
           "train_meta": {m: json.loads((ts / f"train_meta{'' if m == 'opnet' else '_' + m}"
                                               ".json").read_text())
                          for m in ("opnet", *OTHER_MODELS)},
           "models": rows}
    (out / "run.json").write_text(json.dumps(run, indent=2) + "\n")
    print(json.dumps(run), flush=True)


if __name__ == "__main__":
    main()
