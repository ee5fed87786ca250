"""Unbiased-planner evaluation split (paper-comparable distribution), the
counterpart of `scripts/unbiased_eval.py`.

The flagship sim4k runs train AND evaluate on `snitch_bias=0.5`,
containment-guaranteed scenes (denser snitch containment than the
reference's uniform planner). This driver builds a test split with the
reference's distribution (`snitch_bias=0.0`, no containment guarantee) and
evaluates existing checkpoints on it, giving the unbiased second column
next to the biased headline numbers.

    python -m objectpermanence_tpu_torch.experiments.unbiased_eval --models opnet

Inference runs on the card; `--device cpu` runs it on the CPU. The
checkpoints are the port's `.npz` files: a tree of the JAX package's orbax
checkpoints raises, naming `scripts/export_torch_weights.py`.
"""

import argparse
import json
from pathlib import Path

import pandas as pd

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.analysis.offline import analyze_results
from objectpermanence_tpu_torch.datagen import scene_labels
from objectpermanence_tpu_torch.datagen.perfect_perception import PerfectPerceptionGenerator
from objectpermanence_tpu_torch.datagen.simulator import simulate_dataset
from objectpermanence_tpu_torch.experiments.variant_sweep import MODEL_CONFIGS
from objectpermanence_tpu_torch.infer.reasoning import reasoning_inference_main
from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint


def build_split(root: Path, num_videos: int, frames: int, objects: int,
                seed: int) -> None:
    done = root / ".done"
    if done.exists():
        print("[unbiased] split already built", flush=True)
        return
    scenes_dir, labels_dir = simulate_dataset(
        root, num_videos=num_videos, seed=seed, num_frames=frames,
        num_objects=objects, snitch_bias=0.0,
        require_snitch_containment=False)
    scene_labels.write_annotation_files(scenes_dir, root / "annotations")
    gen = PerfectPerceptionGenerator(
        scenes_dir, labels_dir, root / "od_perception",
        visible_ratio=0.99, mode="visible_only")
    gen.generate()
    gen.generate_snitch_visible_frames()
    done.write_text("seed_scheme=v2\n")
    print(f"[unbiased] built {num_videos} uniform-planner scenes", flush=True)


def evaluate(root: Path, model: str, ckpt_dir: Path, cache: Path, device=None):
    best = best_params_checkpoint(ckpt_dir)
    print(f"[unbiased] {model}: {best}", flush=True)
    results_dir = root / f"results_{model}"
    reasoning_inference_main(model, str(results_dir), {
        "batch_size": 300,
        "sample_dir": str(root / "od_perception"),
        "labels_dir": str(root / "labels"),
        "model_path": str(best),
        "cache_dir": str(cache),
    }, MODEL_CONFIGS[model], device=device)
    ann = root / "annotations"
    csv_path = root / f"analysis_{model}.csv"
    analyze_results(
        str(results_dir), str(root / "labels"), str(csv_path),
        str(ann / "containment_annotations.txt"),
        str(ann / "containment_only_static_annotations.txt"),
        str(ann / "containment_with_move_annotations.txt"),
        str(root / "od_perception" / "visibility_rate_gt_0.99.txt"),
        None, None, [0.5, 0.9])
    df = pd.read_csv(csv_path)
    row = {
        "model": model,
        "overall_iou": round(float(df["overall_iou"].mean()), 4),
        "contained_iou": round(float(df["contained_mean_iou"].mean()), 4),
        "contained_ratio": round(float(df["contained_ratio"].mean()), 4),
        "visible_iou": round(float(df["visibility_gt_0_mean_iou"].mean()), 4),
        "map_0.5": round(float(df["overall_map_0.5"].mean()), 4),
    }
    print(f"[unbiased] {row}", flush=True)
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path("data/unbiased"))
    ap.add_argument("--videos", type=int, default=300)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--objects", type=int, default=8)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--models", nargs="+", default=["opnet"])
    ap.add_argument("--checkpoints-root", type=Path,
                    default=Path("data/sim4k"))
    ap.add_argument("--sweep-dir", default="sweep")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where inference runs (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    args.root.mkdir(parents=True, exist_ok=True)
    build_split(args.root, args.videos, args.frames, args.objects, args.seed)

    rows = []
    for model in args.models:
        # sweep layout first (any model trained by variant_sweep);
        # the flagship's opnet lives outside sweep/
        ckpt = args.checkpoints_root / args.sweep_dir / model / model
        if not ckpt.is_dir() and model == "opnet":
            ckpt = args.checkpoints_root / "checkpoints" / "opnet"
        rows.append(evaluate(args.root, model, ckpt, args.root / "cache", device))
    (args.root / "results.json").write_text(json.dumps(rows, indent=2))
    print(json.dumps(rows, indent=2))


if __name__ == "__main__":
    main()
