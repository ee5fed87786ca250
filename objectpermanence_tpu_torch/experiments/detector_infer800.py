"""800 px detector INFERENCE throughput + accuracy matrix on the port, the
counterpart of `scripts/detector_infer800.py`.

Inference at the reference geometry (`min_size=800`, the reference's
`object_detection/training.py`) runs the windowed RoIAlign kernel. This
driver measures the inference path's levers and checks each one keeps
test mAP:

- bf16 compute (backbone/FPN/heads in bfloat16; decode/NMS stay float32)
- reduced proposal budget (rpn pre/post NMS top-n 300/150 and 200/100 vs
  the training recipe's 500/300: detection keeps only score>=0.8 boxes
  downstream, the reference's `baselines/detector.py`, so inference needs
  far fewer proposals)
- batch 16 and 32 (amortizes fixed per-call work)

The accuracy column requires a checkpoint TRAINED at the 800 px geometry
(`detector_800px_run train800`): a native-resolution detector fed
3.33x-upsampled frames still centres boxes on the right objects but
undershoots their size (its box regression never saw that scale), so its
800 px mAP is about 0: domain shift, not a harness fault.

    python -m objectpermanence_tpu_torch.experiments.detector_infer800 --root data/det800
        # writes <root>/infer800.json: fps + test mAP per config

Throughput is timed by CUDA events over `--iters` chained forwards of one
batch already on the card, best of 3, after a warmup call (on the CPU, with
`--device cpu`, by the host clock).
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
from objectpermanence_tpu_torch.experiments.detector_800px_run import seconds_per_call
from objectpermanence_tpu_torch.models.detector.detector import (
    CaterDetector, DetectorConfig, detect_forward,
)
from objectpermanence_tpu_torch.train.detector_loop import evaluate_detector
from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint

CONFIGS = {
    # the geometry's fp32 windowed inference path, the control
    "fp32_windowed": dict(compute_dtype="float32", pre=500, post=300),
    "bf16_windowed": dict(compute_dtype="bfloat16", pre=500, post=300),
    "bf16_win_tuned": dict(compute_dtype="bfloat16", pre=300, post=150),
    "bf16_tuned_b16": dict(compute_dtype="bfloat16", pre=300, post=150,
                           batch=16),
    "bf16_max_b16": dict(compute_dtype="bfloat16", pre=200, post=100,
                         batch=16),
    "bf16_max_b32": dict(compute_dtype="bfloat16", pre=200, post=100,
                         batch=32),
}


def _config(c) -> DetectorConfig:
    return DetectorConfig(min_size=800, max_size=1333, backbone_norm="group",
                          rpn_pre_nms_top_n=c["pre"],
                          rpn_post_nms_top_n=c["post"],
                          compute_dtype=c["compute_dtype"],
                          roi_backend="windowed")


def _batch(c, args) -> int:
    return c.get("batch", args.batch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path("data/det800"))
    ap.add_argument("--ckpt", default=None,
                    help="default: best checkpoint under <root>/det800")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of config names to run "
                         "(rows merge into an existing infer800.json, so "
                         "reruns only pay for the missing rows)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the detector runs (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ckpt = args.ckpt or best_params_checkpoint(args.root / "det800")
    if ckpt is None:
        raise FileNotFoundError(
            f"no detector checkpoint under {args.root / 'det800'} — run "
            f"detector_800px_run train800 first or pass --ckpt")
    print(f"[infer800] checkpoint: {ckpt}", flush=True)
    test_ds = DetectionDataset(args.root / "test" / "det_images",
                               args.root / "test" / "detection_annotations.csv")

    out_path = args.root / "infer800.json"
    rows = json.loads(out_path.read_text()) if out_path.exists() else {}
    todo = (dict(CONFIGS) if args.configs is None else
            {n: CONFIGS[n] for n in args.configs.split(",")})
    for name, c in todo.items():
        config = _config(c)
        batch = _batch(c, args)
        frames = np.random.RandomState(0).randint(0, 255, (batch, 240, 320, 3), dtype=np.uint8)
        det = CaterDetector.load(str(ckpt), config, device=device)
        images = torch.from_numpy(frames).to(device)
        with torch.inference_mode():
            def forward():
                detect_forward(det.model, images, det.config, det.anchors)

            forward()  # warmup
            best = min(seconds_per_call(forward, args.iters, device) for _ in range(3))
        fps = batch / best
        row = {"fps": round(fps, 2), "ms_per_batch": round(best * 1000, 3),
               "batch": batch, **{k: v for k, v in c.items() if k != "batch"}}
        if not args.skip_eval:
            t0 = time.time()
            metrics = evaluate_detector(det, test_ds, batch_size=batch)
            row["test"] = {k: round(float(v), 4) for k, v in metrics.items()}
            row["eval_seconds"] = round(time.time() - t0)
        rows[name] = row
        # written after EVERY config: an interrupted matrix keeps its
        # finished rows on disk
        if "fp32_windowed" in rows:
            base = rows["fp32_windowed"]["fps"]
            for n in rows:
                rows[n]["speedup_vs_fp32"] = round(rows[n]["fps"] / base, 2)
        out_path.write_text(json.dumps(rows, indent=2))
        print(f"[infer800] {name}: {row}", flush=True)
        del det

    print(json.dumps(rows, indent=2))


if __name__ == "__main__":
    main()
