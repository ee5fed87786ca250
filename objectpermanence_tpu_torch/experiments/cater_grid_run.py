"""CATER-setup grid classification accuracy on the scaled runs, the
counterpart of `scripts/cater_grid_run.py`.

The reference's headline CATER metric is 6x6 grid classification of the
last-frame snitch cell (the reference's `baselines/cater_setup_inference.py:
88-103`): project the predicted box center through the image->ground-plane
homography, bin into the 36-way class, score top-1 accuracy (plus the
paper's mean grid L1 distance). GT classes come from the scene jsons
(`datagen/cater_tasks.localization_class` — final-frame snitch world
position binned on the same grid).

    python -m objectpermanence_tpu_torch.experiments.cater_grid_run \
        --root data/sim4k --models opnet transformer_lstm baseline_lstm

Inference runs on the card (`opnet` on the fused kernel, the other models
on the LSTM forward kernel); `--device cpu` runs it on the CPU.
"""

import argparse
import json
from pathlib import Path

import numpy as np

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.datagen.cater_tasks import localization_class
from objectpermanence_tpu_torch.experiments.variant_sweep import MODEL_CONFIGS
from objectpermanence_tpu_torch.infer.cater_setup import cater_setup_inference
from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint


def gt_grid_classes(scenes_dir: Path):
    out = {}
    for scene_path in sorted(scenes_dir.glob("*.json")):
        scene = json.loads(scene_path.read_text())
        out[scene_path.stem] = localization_class(scene)
    return out


def grid_l1(a: int, b: int, ncols: int = 6) -> int:
    return abs(a // ncols - b // ncols) + abs(a % ncols - b % ncols)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path("data/sim4k"))
    ap.add_argument("--src", type=Path, default=None,
                    help="where test scenes/labels live (default: --root)")
    ap.add_argument("--models", nargs="+",
                    default=["opnet", "transformer_lstm", "baseline_lstm"])
    ap.add_argument("--perception", default="od_perception",
                    help="test perception dir name (od_real for two-stage)")
    ap.add_argument("--checkpoints-root", type=Path, default=None,
                    help="default: <root>/sweep/<model> (full-data sweep)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where inference runs (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    src = args.src or args.root
    gt = gt_grid_classes(src / "test" / "scenes")
    rows = []
    for model in args.models:
        if args.checkpoints_root is not None:
            ckpt_dir = args.checkpoints_root / model
        else:
            ckpt_dir = args.root / "sweep" / model / model
        best = best_params_checkpoint(ckpt_dir)
        if best is None:
            print(f"[cater] {model}: no checkpoint under {ckpt_dir}, skipping",
                  flush=True)
            continue
        print(f"[cater] {model}: {best}", flush=True)
        suffix = f"_{args.tag}" if args.tag else ""
        results_dir = args.root / "cater" / f"{model}{suffix}"
        perception_dir = args.root / "test" / args.perception
        df = cater_setup_inference(model, str(results_dir), {
            "batch_size": 300,
            "sample_dir": str(perception_dir),
            "labels_dir": str(src / "test" / "labels"),
            "model_path": str(best),
            "cache_dir": str(args.root / "cache"),
        }, MODEL_CONFIGS[model], device=device)
        pred = {Path(n).stem: int(c) for n, c in
                zip(df["video_names"], df["class_predictions"])}
        common = sorted(set(pred) & set(gt))
        acc = float(np.mean([pred[n] == gt[n] for n in common]))
        l1 = float(np.mean([grid_l1(pred[n], gt[n]) for n in common]))
        rows.append({"model": model + suffix, "videos": len(common),
                     "grid_top1_acc": round(acc, 4),
                     "grid_l1_dist": round(l1, 4)})
        print(f"[cater] {rows[-1]}", flush=True)

    out = args.root / "cater" / "grid_results.json"
    existing = json.loads(out.read_text()) if out.exists() else []
    existing = [r for r in existing
                if r["model"] not in {x["model"] for x in rows}] + rows
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(existing, indent=2))
    print(json.dumps(existing, indent=2))


if __name__ == "__main__":
    main()
