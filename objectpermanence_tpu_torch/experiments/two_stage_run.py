"""Scaled REAL two-stage pipeline on the port: pixels -> Faster R-CNN ->
OPNet, the counterpart of `scripts/two_stage_run.py`.

The reference's primary experiment path feeds OPNet with Faster R-CNN
detections, not ground truth (its `baselines/preprocess_perception_main.py`
-> `baselines/datasets.py`). This driver runs that full path on the scenes
of a `containment_run datagen` root (`--src`):

    render      render every scene to 320x240 MJPG video (host only)
                + sampled PNG frames with the reference detection CSV schema
    dettrain    train the Faster R-CNN (GroupNorm backbone, from scratch)
                on rendered frames; eval mAP on dev/test frames
    preprocess  run the trained detector over every video -> od_real/*.pkl
                (the reference's score>=0.8 perception pickles)
    opnet       ingest REAL detections, train a reasoning model with the
                reference recipe (Adam 1e-3, bs 16, 160 epochs, plateau
                0.8/2); --model picks the architecture (default opnet)
    analyze     held-out test inference + the reference's analysis CSV
                (stratification files = scene GT, as in the reference)

Every stage is resumable; each finished stage leaves a marker or artifact
the next run skips. `dettrain` trains on RoIAlign's exact kernel and its
backward, `preprocess` detects with the exact kernel, `opnet` trains on the
LSTM kernels and `analyze` infers on the fused OPNet kernel (the LSTM kernel
for the other models); `--device cpu` runs them all on the CPU. `preprocess`
runs each split's missing videos in this process in one pass (the
`preprocess-worker` stage runs a split's todo file alone).

    python -m objectpermanence_tpu_torch.experiments.two_stage_run all
"""

import argparse
import dataclasses
import json
import pickle
import time
from pathlib import Path

import numpy as np

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.analysis.offline import analyze_results
from objectpermanence_tpu_torch.config import load_model_config
from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
from objectpermanence_tpu_torch.data.ingest import ingest_directory, training_mask_file
from objectpermanence_tpu_torch.datagen.renderer import render_dataset
from objectpermanence_tpu_torch.infer.preprocess import preprocess_main
from objectpermanence_tpu_torch.infer.reasoning import reasoning_inference_main
from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.train.detector_loop import evaluate_detector, train_detector
from objectpermanence_tpu_torch.train.loop import training_main
from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint
from objectpermanence_tpu_torch.vocab import SNITCH_CLASS_INDEX

SPLITS = ("train", "dev", "test")


def detector_config() -> DetectorConfig:
    return DetectorConfig(min_size=240, max_size=320, backbone_norm="group",
                          rpn_pre_nms_top_n=500, rpn_post_nms_top_n=300)


def render(src: Path, root: Path, det_samples: int) -> None:
    for i, split in enumerate(SPLITS):
        t0 = time.time()
        render_dataset(src / split / "scenes", src / split / "labels",
                       root / split, detection_samples_per_video=det_samples,
                       seed=1000 + i, progress_every=200)
        n = len(list((root / split / "videos").glob("*.avi")))
        print(f"[render] {split}: {n} videos ({time.time()-t0:.0f}s)", flush=True)


def dettrain(root: Path, epochs: int, batch_size: int, lr: float,
             resume: bool = False, device=None) -> None:
    done = root / "detector" / ".done"
    if done.exists():
        print("[dettrain] already complete", flush=True)
        return
    datasets = {s: DetectionDataset(root / s / "det_images",
                                    root / s / "detection_annotations.csv")
                for s in SPLITS}
    for s in SPLITS:
        print(f"[dettrain] {s}: {len(datasets[s])} frames", flush=True)
    config = detector_config()
    t0 = time.time()
    run = train_detector(datasets["train"], datasets["dev"], config,
                         num_epochs=epochs, batch_size=batch_size,
                         learning_rate=lr,
                         checkpoint_dir=str(root / "detector"),
                         print_step=200, resume=resume, device=device)
    print(f"[dettrain] {time.time()-t0:.0f}s best dev mAP {run['best_map']:.4f}",
          flush=True)
    best = _best_detector_ckpt(root)
    detector = CaterDetector.load(str(best), config, device=device)
    test_metrics = evaluate_detector(detector, datasets["test"])
    report = {"best_dev_map": run["best_map"], "test": test_metrics,
              "history": run["history"], "checkpoint": str(best)}
    (root / "detector" / "report.json").write_text(json.dumps(report, indent=2))
    print(f"[dettrain] test: {test_metrics}", flush=True)
    done.touch()


def _best_detector_ckpt(root: Path) -> Path:
    return best_params_checkpoint(root / "detector")


def _preprocess_split_worker(root: Path, split: str, batch_size: int,
                             device=None) -> None:
    """Run the detector over the videos listed in the split's todo file."""
    best = _best_detector_ckpt(root)
    cfg = detector_config()
    t0 = time.time()
    written = preprocess_main(str(root / split / "od_real"), {
        "videos_dir": str(root / split / "videos"),
        "od_model_weights": str(best),
        "sample_file": str(root / split / "preprocess_todo.txt"),
        "batch_size": batch_size,
        # full architecture config: the checkpoint must be restored with
        # the SAME DetectorConfig it was trained with
        **dataclasses.asdict(cfg),
    }, device=device)
    print(f"[preprocess-worker] {split}: {len(written)} videos "
          f"({time.time()-t0:.0f}s)", flush=True)


def preprocess(root: Path, batch_size: int, limit: int = 0, device=None) -> None:
    best = _best_detector_ckpt(root)
    print(f"[preprocess] detector checkpoint: {best}", flush=True)
    for split in SPLITS:
        out_dir = root / split / "od_real"
        out_dir.mkdir(parents=True, exist_ok=True)
        names = sorted(p.stem for p in (root / split / "videos").glob("*.avi"))
        if limit:
            # bounded run: the first N by name, so that reruns and the
            # opnet/analyze stages see a deterministic prefix
            names = names[:limit]
        missing = [n for n in names if not (out_dir / f"{n}.pkl").exists()]
        if missing:
            (root / split / "preprocess_todo.txt").write_text(
                "".join(f"{n}.avi\n" for n in missing))
            _preprocess_split_worker(root, split, batch_size, device)
        done = sum((out_dir / f"{n}.pkl").exists() for n in names)
        # a video that fails to decode is reported by the worker and skipped
        print(f"[preprocess] {split}: {done}/{len(names)} videos detected", flush=True)

    # perception quality stats: how often is the snitch actually detected?
    stats = {}
    for split in SPLITS:
        counts = []
        for pkl_path in sorted((root / split / "od_real").glob("*.pkl")):
            with open(pkl_path, "rb") as f:
                data = pickle.load(f)
            det = sum(SNITCH_CLASS_INDEX in frame for frame in data["labels"])
            counts.append(det / max(len(data["labels"]), 1))
        stats[split] = {"videos": len(counts),
                        "snitch_detection_rate": float(np.mean(counts)),
                        "snitch_rate_p10": float(np.percentile(counts, 10))}
        print(f"[preprocess] {split}: snitch detected in "
              f"{stats[split]['snitch_detection_rate']:.1%} of frames", flush=True)
    (root / "perception_stats.json").write_text(json.dumps(stats, indent=2))


def ingest_split(root: Path, src: Path, split: str, spec):
    """Ingest a split's REAL detections; the loss-mask file is
    `data/ingest.py::training_mask_file`'s (the visible-frames file for
    `*_no_labels` models, the containment file otherwise)."""
    return ingest_directory(
        root / split / "od_real", src / split / "labels",
        spec.feature_width, training_mask_file(spec, src / split),
        str(root / "cache"))


def opnet(root: Path, src: Path, epochs: int, resume: bool,
          model: str = "opnet", device=None) -> None:
    # the model config carries the variants' knobs (opnet_att_ce's
    # att_ce_weight) to the spec
    spec = get_model_spec(model, load_model_config(model))
    datasets = {}
    for split in ("train", "dev"):
        datasets[split] = ingest_split(root, src, split, spec)
        print(f"[{model}] ingested {split}: {len(datasets[split])} videos",
              flush=True)
    train_config = {
        "batch_size": 16, "inference_batch_size": 400,
        "num_epochs": epochs, "print_step": 100, "learning_rate": 1e-3,
        "lr_scheduler_patience": 2, "lr_scheduler_factor": 0.8,
        "checkpoints_path": str(root / "checkpoints"),
        "metrics_file": str(root / ("metrics.jsonl" if model == "opnet"
                                    else f"metrics_{model}.jsonl")),
        "train_sample_dir": "x", "train_labels_dir": "x",
        "train_containment_file": "x", "dev_sample_dir": "x",
        "dev_labels_dir": "x", "dev_containment_file": "x",
    }
    result = training_main(spec, datasets["train"], datasets["dev"],
                           train_config, load_model_config(model),
                           resume=resume, device=device)
    print(f"[{model}] best dev mIoU: {result.best_dev_iou:.4f}", flush=True)
    # provenance stamp: which run produced the live metrics and checkpoints
    suffix = "" if model == "opnet" else f"_{model}"
    (root / f"train_meta{suffix}.json").write_text(json.dumps({
        "model": model,
        "train_videos": len(datasets["train"]),
        "dev_videos": len(datasets["dev"]),
        "epochs": epochs,
        "best_dev_iou": round(float(result.best_dev_iou), 4),
        "completed_unix": time.time(),
    }, indent=2))


def analyze(root: Path, src: Path, model: str = "opnet", device=None) -> None:
    test_src = src / "test"
    suffix = "" if model == "opnet" else f"_{model}"
    results_dir = root / ("results" + suffix)
    best = best_params_checkpoint(root / "checkpoints" / model)
    if best is None:
        raise FileNotFoundError(
            f"no trained {model} checkpoint under {root / 'checkpoints'} — "
            f"run the train stage first")
    print(f"[analyze] using checkpoint {best}", flush=True)
    inference_config = {
        "batch_size": 200,
        "sample_dir": str(root / "test" / "od_real"),
        "labels_dir": str(test_src / "labels"),
        "model_path": str(best),
        "cache_dir": str(root / "cache"),
    }
    reasoning_inference_main(model, str(results_dir), inference_config,
                             load_model_config(model), device=device)
    ann = test_src / "annotations"
    # stratification (containment spans, GT snitch visibility) is scene
    # ground truth, shared with the perfect-perception run by design
    analyze_results(
        str(results_dir), str(test_src / "labels"),
        str(root / f"analysis{suffix}.csv"),
        str(ann / "containment_annotations.txt"),
        str(ann / "containment_only_static_annotations.txt"),
        str(ann / "containment_with_move_annotations.txt"),
        str(test_src / "od_perception" / "visibility_rate_gt_0.99.txt"),
        None, None, [0.5, 0.9])
    print((root / f"analysis{suffix}.csv").read_text(), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=["render", "dettrain", "preprocess",
                                      "preprocess-worker", "opnet", "analyze",
                                      "all"])
    ap.add_argument("--split", choices=SPLITS, default=None,
                    help="(preprocess-worker) which split's todo to run")
    ap.add_argument("--root", type=Path, default=Path("data/twostage"))
    ap.add_argument("--src", type=Path, default=Path("data/sim2k"))
    ap.add_argument("--det-samples", type=int, default=2)
    ap.add_argument("--det-epochs", type=int, default=16)
    ap.add_argument("--det-batch", type=int, default=8)
    ap.add_argument("--det-lr", type=float, default=5e-3)
    ap.add_argument("--preprocess-batch", type=int, default=32)
    ap.add_argument("--limit", type=int, default=0,
                    help="(preprocess) cap each split at its first N videos "
                         "(0 = all); dev/test are smaller than typical caps "
                         "so this effectively bounds the train split")
    ap.add_argument("--epochs", type=int, default=160)
    ap.add_argument("--model", default="opnet",
                    help="(opnet/analyze) reasoning architecture to train on "
                         "the real detections")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every stage but render runs (default: the card)")
    args = ap.parse_args(argv)

    # the card is checked before any stage runs: a run asked for the card
    # never goes on without it
    device = resolve_device(args.device) if args.stage != "render" else None
    args.root.mkdir(parents=True, exist_ok=True)
    if args.stage == "render":
        render(args.src, args.root, args.det_samples)
    if args.stage in ("dettrain", "all"):
        dettrain(args.root, args.det_epochs, args.det_batch, args.det_lr,
                 resume=args.resume, device=device)
    if args.stage == "preprocess-worker":
        _preprocess_split_worker(args.root, args.split, args.preprocess_batch, device)
    if args.stage in ("preprocess", "all"):
        preprocess(args.root, args.preprocess_batch, limit=args.limit, device=device)
    if args.stage in ("opnet", "all"):
        opnet(args.root, args.src, args.epochs, args.resume, args.model, device)
    if args.stage in ("analyze", "all"):
        analyze(args.root, args.src, args.model, device)


if __name__ == "__main__":
    main()
