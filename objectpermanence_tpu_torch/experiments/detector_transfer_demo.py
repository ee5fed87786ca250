"""Pretrained-checkpoint fine-tuning demonstration on the port, the
counterpart of `scripts/detector_transfer_demo.py`.

The reference fine-tunes a COCO-pretrained torchvision checkpoint (its
`object_detection/models.py`); with no COCO weights at hand the
demonstration uses a surrogate: pretrain the detector on one rendered
dataset, SAVE IT AS A TORCH CHECKPOINT in the reference's format
(`torch.save` of a torchvision-named state_dict in `{"model_state_dict":
...}`, what the reference's `baselines/detector.py` loads), reload it
through `CaterDetector.load`, then fine-tune on a second dataset from the
loaded weights versus from scratch. The claim under test: the torch
checkpoint path is complete and transfer beats random init.

    python -m objectpermanence_tpu_torch.experiments.detector_transfer_demo [--pretrain-epochs 12]

Training runs on the card (RoIAlign's exact kernel and its backward; in
bfloat16 with `--bf16`); `--device cpu` runs it on the CPU.
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
from objectpermanence_tpu_torch.datagen.renderer import render_dataset
from objectpermanence_tpu_torch.datagen.simulator import simulate_dataset
from objectpermanence_tpu_torch.models.detector.convert import export_torchvision_state_dict
from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
from objectpermanence_tpu_torch.train.detector_loop import train_detector


def build_dataset(root: Path, tag: str, num_videos: int, seed: int,
                  samples_per_video: int = 6) -> DetectionDataset:
    out = root / tag
    scenes_dir, labels_dir = simulate_dataset(
        out, num_videos=num_videos, seed=seed, num_frames=60, num_objects=6,
        require_snitch_containment=False)
    _, det_dir, csv_path = render_dataset(
        scenes_dir, labels_dir, out,
        detection_samples_per_video=samples_per_video, seed=seed)
    return DetectionDataset(det_dir, csv_path)


def detector_config(bf16: bool) -> DetectorConfig:
    return DetectorConfig(
        min_size=240, max_size=320, rpn_pre_nms_top_n=500,
        rpn_post_nms_top_n=300,
        compute_dtype="bfloat16" if bf16 else "float32")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path("data/transfer"))
    ap.add_argument("--pretrain-epochs", type=int, default=12)
    ap.add_argument("--finetune-epochs", type=int, default=4)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where training runs (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    args.root.mkdir(parents=True, exist_ok=True)
    config = detector_config(args.bf16)

    print("[transfer] building datasets...", flush=True)
    pretrain_ds = build_dataset(args.root, "pretrain", 24, seed=100)
    finetune_ds = build_dataset(args.root, "finetune", 8, seed=200)
    finetune_eval = build_dataset(args.root, "finetune_eval", 4, seed=300)

    print(f"[transfer] pretraining on {len(pretrain_ds)} frames...", flush=True)
    t0 = time.time()
    pre = train_detector(pretrain_ds, None, config,
                         num_epochs=args.pretrain_epochs, batch_size=8,
                         checkpoint_dir=str(args.root / "ckpt_pre"),
                         print_step=1000, device=device)
    print(f"[transfer] pretrain {time.time()-t0:.0f}s", flush=True)

    # save in the reference's torch checkpoint format and reload through
    # the converter path (the one COCO weights would take)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          export_torchvision_state_dict(pre["model"]).items()}
    pth = args.root / "pretrained.pth"
    torch.save({"model_state_dict": sd}, pth)
    loaded = CaterDetector.load(str(pth), config, device=device)

    results = {}
    for tag, init_params in (("from_pretrained", loaded.model.state_dict()),
                             ("from_scratch", None)):
        print(f"[transfer] fine-tune {tag}...", flush=True)
        run = train_detector(
            finetune_ds, finetune_eval, config,
            num_epochs=args.finetune_epochs, batch_size=8,
            checkpoint_dir=str(args.root / f"ckpt_{tag}"),
            print_step=1000, init_params=init_params, device=device)
        results[tag] = {"best_map": run["best_map"],
                        "history": [{k: v for k, v in h.items()}
                                    for h in run["history"]]}
        print(f"[transfer] {tag}: best mAP {run['best_map']:.4f}", flush=True)

    (args.root / "results.json").write_text(json.dumps(results, indent=2))
    gain = results["from_pretrained"]["best_map"] - results["from_scratch"]["best_map"]
    print(f"[transfer] pretrained-vs-scratch mAP gain: {gain:+.4f}")


if __name__ == "__main__":
    main()
