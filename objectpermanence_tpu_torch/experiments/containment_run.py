"""Scaled containment-tracking run on the port: the paper-parity
demonstration, the counterpart of `scripts/containment_run.py`.

Reproduces the reference's headline experiment (ECCV'20 "Learning Object
Permanence from Video": OPNet trained on perception sequences, evaluated on
containment tracking) on simulated CATER scenes: the randomized
rejection-sampled planner (`datagen/simulator.py`, the port of the
reference's `generate/actions.py`) generates diverse multi-object /
nested-containment scenes; perfect perception (visible_only) provides the
detector-equivalent input; training uses the reference recipe (the
reference's `configs/training_config.json`: Adam 1e-3, batch 16, 160
epochs, plateau 0.8/2).

Stages (each resumable / skippable):
    python -m objectpermanence_tpu_torch.experiments.containment_run --root R datagen
    python -m objectpermanence_tpu_torch.experiments.containment_run --root R train
    python -m objectpermanence_tpu_torch.experiments.containment_run --root R analyze

`train` and `analyze` run on the card (OPNet's training on the LSTM
kernels, its inference on the fused kernel); `--device cpu` runs them on
the CPU. `datagen` runs on the host. The scenes, labels, annotations and
perception pickles are byte for byte those of the JAX script at the same
seeds, so a root that either one generated is valid for both.
"""

import argparse
import json
import tempfile
import time
from pathlib import Path

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.analysis.offline import analyze_results
from objectpermanence_tpu_torch.config import load_model_config
from objectpermanence_tpu_torch.data.ingest import ingest_directory, training_mask_file
from objectpermanence_tpu_torch.datagen import scene_labels
from objectpermanence_tpu_torch.datagen.perfect_perception import PerfectPerceptionGenerator
from objectpermanence_tpu_torch.datagen.simulator import simulate_dataset
from objectpermanence_tpu_torch.infer.reasoning import reasoning_inference_main
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.train.loop import training_main
from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint


def gen_split(root: Path, split: str, num_videos: int, seed: int,
              num_frames: int, num_objects: int, snitch_bias: float = 0.5,
              require_containment: bool = True) -> None:
    split_dir = root / split
    done = split_dir / ".done"
    if done.exists():
        # version the marker (seed-scheme v2 = disjoint (seed<<20) blocks):
        # a pre-v2 dataset may contain cross-split duplicate scenes and must
        # not be silently reused. Markers written before versioning are
        # verified by re-simulating video 0 and byte-comparing.
        if done.read_text().strip() != "seed_scheme=v2":
            with tempfile.TemporaryDirectory() as tmp:
                sdir, _ = simulate_dataset(Path(tmp), num_videos=1, seed=seed,
                                           num_frames=num_frames, num_objects=num_objects,
                                           snitch_bias=snitch_bias,
                                           require_snitch_containment=require_containment)
                fresh = json.loads((sdir / "CATER_sim_000000.json").read_text())
            on_disk = json.loads(
                (split_dir / "scenes" / "CATER_sim_000000.json").read_text())
            if fresh != on_disk:
                raise RuntimeError(
                    f"{split_dir} was generated under the pre-v2 seed scheme "
                    f"(cross-split scene collisions possible); delete it and "
                    f"re-run datagen")
            done.write_text("seed_scheme=v2\n")
        print(f"[datagen] {split}: already complete", flush=True)
        return
    t0 = time.time()
    scenes_dir, labels_dir = simulate_dataset(
        split_dir, num_videos=num_videos, seed=seed, num_frames=num_frames,
        num_objects=num_objects, snitch_bias=snitch_bias,
        require_snitch_containment=require_containment)
    print(f"[datagen] {split}: {num_videos} scenes in {time.time()-t0:.0f}s",
          flush=True)
    t0 = time.time()
    scene_labels.write_annotation_files(scenes_dir, split_dir / "annotations")
    gen = PerfectPerceptionGenerator(
        scenes_dir, labels_dir, split_dir / "od_perception",
        visible_ratio=0.99, mode="visible_only")
    gen.generate()
    gen.generate_snitch_visible_frames()
    print(f"[datagen] {split}: labels+perception in {time.time()-t0:.0f}s",
          flush=True)
    done.write_text("seed_scheme=v2\n")


def train(root: Path, epochs: int, resume: bool, device=None) -> None:
    spec = get_model_spec("opnet")
    cache = str(root / "cache")
    datasets = {}
    for split in ("train", "dev"):
        d = root / split
        datasets[split] = ingest_directory(
            d / "od_perception", d / "labels", spec.feature_width,
            training_mask_file(spec, d), cache)
        print(f"[train] ingested {split}: {len(datasets[split])} videos",
              flush=True)

    # the reference recipe, configs/training_config.json
    train_config = {
        "batch_size": 16, "inference_batch_size": 400,
        "num_epochs": epochs, "print_step": 100, "learning_rate": 1e-3,
        "lr_scheduler_patience": 2, "lr_scheduler_factor": 0.8,
        "checkpoints_path": str(root / "checkpoints"),
        "metrics_file": str(root / "metrics.jsonl"),
        "train_sample_dir": "x", "train_labels_dir": "x",
        "train_containment_file": "x", "dev_sample_dir": "x",
        "dev_labels_dir": "x", "dev_containment_file": "x",
    }
    model_config = load_model_config("opnet")
    result = training_main(spec, datasets["train"], datasets["dev"],
                           train_config, model_config, resume=resume, device=device)
    print(f"[train] best dev mIoU: {result.best_dev_iou:.4f}", flush=True)


def analyze(root: Path, device=None) -> None:
    """Held-out inference + the reference's offline analysis CSV."""
    test_dir = root / "test"
    results_dir = root / "results"
    best = best_params_checkpoint(root / "checkpoints" / "opnet")
    print(f"[analyze] using checkpoint {best}", flush=True)
    inference_config = {
        "batch_size": 200,
        "sample_dir": str(test_dir / "od_perception"),
        "labels_dir": str(test_dir / "labels"),
        "model_path": str(best),
        "cache_dir": str(root / "cache"),
    }
    model_config = load_model_config("opnet")
    reasoning_inference_main("opnet", str(results_dir), inference_config,
                             model_config, device=device)
    ann = test_dir / "annotations"
    analyze_results(
        str(results_dir), str(test_dir / "labels"),
        str(root / "analysis.csv"),
        str(ann / "containment_annotations.txt"),
        str(ann / "containment_only_static_annotations.txt"),
        str(ann / "containment_with_move_annotations.txt"),
        str(test_dir / "od_perception" / "visibility_rate_gt_0.99.txt"),
        None, None, [0.5, 0.9])
    print((root / "analysis.csv").read_text(), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=["datagen", "train", "analyze", "all"])
    ap.add_argument("--root", type=Path, default=Path("data/sim2k"))
    ap.add_argument("--train-videos", type=int, default=1600)
    ap.add_argument("--dev-videos", type=int, default=200)
    ap.add_argument("--test-videos", type=int, default=200)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--objects", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=160)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--snitch-bias", type=float, default=0.5,
                    help="planner bias toward snitch containment actions; "
                         "0.0 = the reference's uniform planner "
                         "(its generate/actions.py:78-149)")
    ap.add_argument("--uniform-planner", action="store_true",
                    help="shorthand: --snitch-bias 0.0 plus NO containment "
                         "guarantee (the reference's actual distribution)")
    ap.add_argument("--seed-base", type=int, default=0,
                    help="added to the per-split seeds (1/2/3); use a "
                         "distinct base per dataset root so scenes are "
                         "disjoint across datasets")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where train and analyze run (default: the card)")
    args = ap.parse_args(argv)

    snitch_bias = 0.0 if args.uniform_planner else args.snitch_bias
    require_containment = not args.uniform_planner
    # the card is checked before any stage runs: a run asked for the card
    # never goes on without it
    device = (resolve_device(args.device) if args.stage in ("train", "analyze", "all")
              else None)

    args.root.mkdir(parents=True, exist_ok=True)
    if args.stage in ("datagen", "all"):
        gen_split(args.root, "train", args.train_videos, args.seed_base + 1,
                  args.frames, args.objects, snitch_bias, require_containment)
        gen_split(args.root, "dev", args.dev_videos, args.seed_base + 2,
                  args.frames, args.objects, snitch_bias, require_containment)
        gen_split(args.root, "test", args.test_videos, args.seed_base + 3,
                  args.frames, args.objects, snitch_bias, require_containment)
    if args.stage in ("train", "all"):
        train(args.root, args.epochs, args.resume, device)
    if args.stage in ("analyze", "all"):
        analyze(args.root, device)


if __name__ == "__main__":
    main()
