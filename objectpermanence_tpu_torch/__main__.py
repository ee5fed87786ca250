"""CLI of the port: `python -m objectpermanence_tpu_torch <mode> ...`.

The same subcommands and flags as the JAX package's `main.py`: `inference`
and `training` of every learned model, `preprocess` (the Faster R-CNN
detector over videos), `analysis` (IoU and mAP of a predictions directory
as a CSV) and `cater_inference` (the 36-way grid class of each video's last
box). The two programmed models (`detector_tracker`, `detector_heuristic`)
are not ported yet: their `inference` exits non-zero saying so.
"""

import argparse
import json
import sys
from typing import Any, Dict

from objectpermanence_tpu_torch.models.registry import (
    INFERENCE_SUPPORTED_MODELS, TRAINING_SUPPORTED_MODELS, get_model_spec,
)


def _load_json(path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="training and inference over the CATER data (PyTorch/CUDA port)")
    subparsers = parser.add_subparsers()

    inference_parser = subparsers.add_parser("inference")
    inference_parser.set_defaults(mode="inference")
    inference_parser.add_argument("--model_type", type=str, required=True,
                                  choices=INFERENCE_SUPPORTED_MODELS)
    inference_parser.add_argument("--results_dir", type=str, required=True)
    inference_parser.add_argument("--inference_config", type=str, required=True)
    inference_parser.add_argument("--model_config", type=str, required=False)

    preprocess_parser = subparsers.add_parser("preprocess")
    preprocess_parser.set_defaults(mode="preprocess")
    preprocess_parser.add_argument("--results_dir", type=str, required=True)
    preprocess_parser.add_argument("--config", type=str, required=True)

    training_parser = subparsers.add_parser("training")
    training_parser.set_defaults(mode="training")
    training_parser.add_argument("--model_type", type=str, required=True,
                                 choices=TRAINING_SUPPORTED_MODELS)
    training_parser.add_argument("--model_config", type=str, required=True)
    training_parser.add_argument("--training_config", type=str, required=True)
    training_parser.add_argument("--resume", action="store_true")

    analysis_parser = subparsers.add_parser("analysis")
    analysis_parser.set_defaults(mode="analysis")
    analysis_parser.add_argument("--predictions_dir", type=str, required=True)
    analysis_parser.add_argument("--labels_dir", type=str, required=True)
    for flag in ("--containment_annotations", "--containment_only_static_annotations",
                 "--containment_with_movements_annotations", "--visibility_ratio_gt_0",
                 "--visibility_ratio_gt_30", "--visibility_ratio_gt_99"):
        analysis_parser.add_argument(flag, type=str, required=False)
    analysis_parser.add_argument("--iou_thresholds", type=str, required=True)
    analysis_parser.add_argument("--output_file", type=str, required=True)

    cater_parser = subparsers.add_parser("cater_inference")
    cater_parser.set_defaults(mode="cater_inference")
    cater_parser.add_argument("--results_dir", type=str, required=True)
    cater_parser.add_argument("--inference_config", type=str, required=True)
    cater_parser.add_argument("--model_config", type=str, required=False)
    cater_parser.add_argument("--model_type", type=str, default="opnet",
                              choices=TRAINING_SUPPORTED_MODELS)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    mode = getattr(args, "mode", None)
    if mode is None:
        parser.print_help()
        return 0
    if mode == "preprocess":
        from objectpermanence_tpu_torch.infer.preprocess import preprocess_main
        preprocess_main(args.results_dir, _load_json(args.config))
        return 0
    if mode == "analysis":
        from objectpermanence_tpu_torch.analysis.offline import analyze_results
        iou_thresholds = [float(t) for t in args.iou_thresholds.split(",")]
        analyze_results(args.predictions_dir, args.labels_dir, args.output_file,
                        args.containment_annotations, args.containment_only_static_annotations,
                        args.containment_with_movements_annotations, args.visibility_ratio_gt_0,
                        args.visibility_ratio_gt_30, args.visibility_ratio_gt_99, iou_thresholds)
        return 0
    if mode == "cater_inference":
        if args.model_config is None:
            parser.error("cater_inference needs --model_config")
        from objectpermanence_tpu_torch.infer.cater_setup import cater_setup_inference
        cater_setup_inference(args.model_type, args.results_dir,
                              _load_json(args.inference_config), _load_json(args.model_config))
        return 0
    try:
        spec = get_model_spec(args.model_type)
    except NotImplementedError as exc:
        print(f"{mode} for {args.model_type}: not yet ported ({exc})", file=sys.stderr)
        return 2

    if mode == "training":
        return _training(args, spec)
    if args.model_config is None:
        parser.error("inference of a learned model needs --model_config")
    from objectpermanence_tpu_torch.infer.reasoning import reasoning_inference_main
    reasoning_inference_main(args.model_type, args.results_dir,
                             _load_json(args.inference_config), _load_json(args.model_config))
    return 0


def _training(args, spec) -> int:
    """`main.py`'s training mode: ingest train and dev with their
    containment files, then `training_main`. The device is resolved first,
    so a run meant for the card fails before it ingests anything."""
    from objectpermanence_tpu_torch import resolve_device
    from objectpermanence_tpu_torch.config import config_device, training_config_from
    from objectpermanence_tpu_torch.data.ingest import ingest_directory
    from objectpermanence_tpu_torch.train.loop import training_main

    model_config = _load_json(args.model_config)
    train_config = _load_json(args.training_config)
    cfg = training_config_from(train_config)
    device = resolve_device(config_device(cfg.device))
    train_dataset = ingest_directory(cfg.train_sample_dir, cfg.train_labels_dir,
                                     spec.feature_width, cfg.train_containment_file,
                                     cfg.cache_dir)
    dev_dataset = ingest_directory(cfg.dev_sample_dir, cfg.dev_labels_dir, spec.feature_width,
                                   cfg.dev_containment_file, cfg.cache_dir)
    training_main(spec, train_dataset, dev_dataset, cfg, model_config, resume=args.resume,
                  device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
