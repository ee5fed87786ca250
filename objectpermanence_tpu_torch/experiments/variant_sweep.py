"""Learned-model comparison on the simulated containment benchmark, the
counterpart of `scripts/variant_sweep.py`.

The reference paper's core table compares OPNet against the learned
baselines (BaselineLstm / NonLinearLstm / TransformerLstm / OPNetLstmMlp)
and the programmed reasoners on snitch localization. This driver trains
each requested variant with the reference recipe on a containment dataset
built by `containment_run datagen`, evaluates on the held-out test split
through the real inference + analyzer path, and writes one results table.

    python -m objectpermanence_tpu_torch.experiments.variant_sweep \
        --root data/sim4k --epochs 60 --train-limit 800 \
        --models opnet baseline_lstm non_linear_lstm

Training and inference run on the card; `--device cpu` runs them on the
CPU. Checkpoints are the port's `<stamp>_<dev_miou>.npz` files under
`<root>/<sweep-dir>/<model>/<model>/`.
"""

import argparse
import json
import time
from pathlib import Path

import pandas as pd

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.analysis.offline import analyze_results
# single source of truth: the shipped configs/<model>_model_config.json
# (same files and keys as the reference's configs/)
from objectpermanence_tpu_torch.config import load_model_config
# safety-critical selection shared with every training driver — see the
# docstring at the definition
from objectpermanence_tpu_torch.data.ingest import (
    IngestedDataset, ingest_directory, training_mask_file,
)
from objectpermanence_tpu_torch.infer.reasoning import reasoning_inference_main
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.train.loop import training_main
from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint

DEFAULT_MODELS = ("opnet", "opnet_lstm_mlp", "baseline_lstm",
                  "non_linear_lstm", "transformer_lstm",
                  # visible-frames-only supervision ablation (masked L1 +
                  # 0.5*consistency, reference `training_main.py:199-210`)
                  "opnet_no_labels", "baseline_lstm_no_labels")

MODEL_CONFIGS = {
    m: load_model_config(m)
    for m in ("opnet", "opnet_lstm_mlp", "baseline_lstm",
              "non_linear_lstm", "transformer_lstm")
}
for _m in list(MODEL_CONFIGS):
    MODEL_CONFIGS[_m + "_no_labels"] = MODEL_CONFIGS[_m]
# beyond-reference MoE variant: opnet config + default num_experts/
# expert_hidden (models/reasoning.py::OPNetMoE)
MODEL_CONFIGS["opnet_moe"] = MODEL_CONFIGS["opnet"]
# beyond-reference attention-CE variant: same net, adds the supervision the
# reference computes but never uses (training_main.py:185-186)
MODEL_CONFIGS["opnet_att_ce"] = MODEL_CONFIGS["opnet"]


def subset(dataset, limit):
    if limit is None or limit >= len(dataset):
        return dataset
    return IngestedDataset(
        dataset.names[:limit], dataset.boxes[:limit],
        (dataset.index_to_track[:limit]
         if dataset.index_to_track is not None else None),
        dataset.labels[:limit],
        (dataset.containment_mask[:limit]
         if dataset.containment_mask is not None else None))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path("data/sim4k"))
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--train-limit", type=int, default=800)
    ap.add_argument("--models", nargs="+", default=list(DEFAULT_MODELS))
    ap.add_argument("--sweep-dir", default="sweep",
                    help="results/checkpoints subdir under --root (use a "
                         "distinct dir per budget, e.g. sweep_160ep_800)")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training when a best-dev checkpoint already "
                         "exists (recover the table row after a crash "
                         "between training and evaluation)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="overlay a model-config key for every swept model "
                         "(e.g. --set att_ce_weight=0.3); values parse as "
                         "json, falling back to string")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where training and inference run (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    overrides = {}
    for kv in args.overrides:
        key, _, raw = kv.partition("=")
        try:
            overrides[key] = json.loads(raw)
        except json.JSONDecodeError:
            overrides[key] = raw

    root = args.root
    cache = str(root / "cache")
    sweep_root = root / args.sweep_dir
    results_path = sweep_root / "results.json"
    # merge with prior invocations (per-model rows keyed by name), so the
    # table accumulates across partial sweeps
    rows = (json.loads(results_path.read_text())
            if results_path.exists() else [])
    for model in args.models:
        model_cfg = {**MODEL_CONFIGS[model], **overrides}
        spec = get_model_spec(model, model_cfg)
        ckpt_dir = sweep_root / model
        best_existing = best_params_checkpoint(ckpt_dir / model)
        if args.eval_only and best_existing is not None:
            print(f"[sweep] eval-only: reusing {best_existing}", flush=True)
            # both sources are rounded: a prior results row keeps 4 decimals,
            # the checkpoint's name (<dd-mm-yy>_<dev_iou>.npz, train/loop.py)
            # only 3 — prefer the row when one exists. The mIoU is the
            # stem's last field, as best_params_checkpoint scores it.
            prior = next((r for r in rows if r["model"] == model), None)
            best_dev = (prior["best_dev_miou"] if prior
                        else float(best_existing.stem.rsplit("_", 1)[-1]))
            # explicit sentinel (not None) so the row schema stays stable
            # when no prior row recorded a duration — including prior rows
            # written before the sentinel existed (train_seconds: null)
            train_s = prior.get("train_seconds") if prior else None
            train_s = -1 if train_s is None else train_s
        else:
            datasets = {}
            for split in ("train", "dev"):
                d = root / split
                datasets[split] = ingest_directory(
                    d / "od_perception", d / "labels", spec.feature_width,
                    training_mask_file(spec, d), cache)
            train_ds = subset(datasets["train"], args.train_limit)
            train_config = {
                "batch_size": 16, "inference_batch_size": 400,
                "num_epochs": args.epochs, "print_step": 1000,
                "learning_rate": 1e-3, "lr_scheduler_patience": 2,
                "lr_scheduler_factor": 0.8,
                "checkpoints_path": str(ckpt_dir),
                "metrics_file": str(ckpt_dir / "metrics.jsonl"),
                "train_sample_dir": "x", "train_labels_dir": "x",
                "train_containment_file": "x", "dev_sample_dir": "x",
                "dev_labels_dir": "x", "dev_containment_file": "x",
            }
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            print(f"[sweep] training {model} ({len(train_ds)} videos, "
                  f"{args.epochs} epochs)...", flush=True)
            t0 = time.time()
            result = training_main(spec, train_ds, datasets["dev"],
                                   train_config, model_cfg, device=device)
            train_s = round(time.time() - t0)
            best_dev = result.best_dev_iou

        best = best_params_checkpoint(ckpt_dir / model)
        test_dir = root / "test"
        inference_config = {
            "batch_size": 300,
            "sample_dir": str(test_dir / "od_perception"),
            "labels_dir": str(test_dir / "labels"),
            "model_path": str(best), "cache_dir": cache,
        }
        results_dir = sweep_root / f"results_{model}"
        reasoning_inference_main(model, str(results_dir), inference_config,
                                 model_cfg, device=device)
        ann = test_dir / "annotations"
        csv_path = sweep_root / f"analysis_{model}.csv"
        analyze_results(
            str(results_dir), str(test_dir / "labels"), str(csv_path),
            str(ann / "containment_annotations.txt"),
            str(ann / "containment_only_static_annotations.txt"),
            str(ann / "containment_with_move_annotations.txt"),
            str(test_dir / "od_perception" / "visibility_rate_gt_0.99.txt"),
            None, None, [0.5, 0.9])
        df = pd.read_csv(csv_path)
        rows = [r for r in rows if r["model"] != model]
        rows.append({
            "model": model,
            **({"config_overrides": overrides} if overrides else {}),
            "best_dev_miou": round(best_dev, 4),
            "test_overall_iou": round(float(df["overall_iou"].mean()), 4),
            "test_contained_iou": round(
                float(df["contained_mean_iou"].mean()), 4),
            "test_visible_iou": round(
                float(df["visibility_gt_0_mean_iou"].mean()), 4),
            "test_map_0.5": round(float(df["overall_map_0.5"].mean()), 4),
            "train_seconds": train_s,
        })
        print(f"[sweep] {model}: {rows[-1]}", flush=True)
        results_path.write_text(json.dumps(rows, indent=2))

    hdr = ["model", "best_dev_miou", "test_overall_iou",
           "test_contained_iou", "test_visible_iou", "test_map_0.5"]
    print("  ".join(f"{h:>18s}" for h in hdr))
    for r in rows:
        print("  ".join(f"{str(r[h]):>18s}" for h in hdr))


if __name__ == "__main__":
    main()
