"""OTB-style programmed-baseline benchmark on rendered fixtures, on the
port: the counterpart of `scripts/tracker_benchmark.py`.

The comparison the reference's DaSiamRPN results culture implies (its
`baselines/DaSiamRPN/README.md`): OPE success AUC / precision@20px for the
two programmed reasoners (`detector_heuristic`, `detector_tracker`) driven
through the real inference path over rendered pixel videos +
perfect-perception detections, plus the raw SiamRPN tracker scored by the
OTB harness (`analysis/tracker_eval.py`) on the same sequences.

    python -m objectpermanence_tpu_torch.experiments.tracker_benchmark [--videos 12] [--weights w.npz]

SiamRPN runs on the card (library convolutions; none of the port's own
kernels), `--device cpu` on the CPU; the heuristic runs on the host. Frames
are decoded by `infer/trackers.py::read_video_bgr`.
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.analysis.analyzer import parse_gt_bb_json
from objectpermanence_tpu_torch.analysis.tracker_eval import evaluate_tracker, ope_metrics
from objectpermanence_tpu_torch.datagen.perfect_perception import PerfectPerceptionGenerator
from objectpermanence_tpu_torch.datagen.renderer import render_dataset
from objectpermanence_tpu_torch.datagen.simulator import simulate_dataset
from objectpermanence_tpu_torch.infer import trackers
from objectpermanence_tpu_torch.models.siam import build_siam_reasoner

MODELS = ("detector_heuristic", "detector_tracker")


def build_fixture_set(root: Path, num_videos: int, frames: int) -> dict:
    scenes_dir, labels_dir = simulate_dataset(
        root, num_videos=num_videos, seed=77, num_frames=frames,
        num_objects=6, snitch_bias=0.5)
    videos_dir, _, _ = render_dataset(scenes_dir, labels_dir, root,
                                      detection_samples_per_video=1)
    gen = PerfectPerceptionGenerator(scenes_dir, labels_dir,
                                     root / "od_perception",
                                     visible_ratio=0.99, mode="visible_only")
    gen.generate()
    return {"scenes": scenes_dir, "labels": labels_dir, "videos": videos_dir,
            "perception": root / "od_perception"}


def _xyxy_to_xywh(boxes: np.ndarray) -> np.ndarray:
    return np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 2] - boxes[:, 0],
                     boxes[:, 3] - boxes[:, 1]], axis=1)


def reasoner_ope(root: Path, dirs: dict, model_type: str, weights: str,
                 resume: bool = False, device=None) -> dict:
    """Drive the real inference path for one programmed reasoner and score
    its snitch predictions with the OTB OPE metrics."""
    config = {"sample_dir": str(dirs["perception"]),
              "labels_dir": str(dirs["labels"]),
              "videos_dir": str(dirs["videos"]),
              "model_path": weights,
              # --resume ONLY: reusing results produced with different
              # weights would silently score the old model's predictions
              "skip_existing": resume}
    t0 = time.time()
    predictions = trackers.trackers_inference_main(
        model_type, str(root / f"results_{model_type}"), config, device=device)
    elapsed = time.time() - t0
    per_video = []
    for name, pred in predictions.items():
        gt = parse_gt_bb_json(dirs["labels"] / f"{name}_bb.json")
        pred = np.asarray(pred, np.float64)
        gt = np.asarray(gt, np.float64)[:len(pred)]
        per_video.append(ope_metrics(_xyxy_to_xywh(gt), _xyxy_to_xywh(pred)))
    out = {k: float(np.mean([m[k] for m in per_video])) for k in per_video[0]}
    out["seconds"] = round(elapsed, 1)
    return out


def raw_siam_ope(dirs: dict, weights: str, device=None) -> dict:
    """Score the bare SiamRPN tracker (no detector assist) with the OTB
    harness: init on the snitch's frame-0 GT box, track through the video."""
    sequences = []
    for video_path in sorted(dirs["videos"].glob("*.avi")):
        frames = list(trackers.read_video_bgr(video_path))
        gt = np.asarray(parse_gt_bb_json(
            dirs["labels"] / f"{video_path.stem}_bb.json"), np.float64)
        frames = frames[:len(gt)]  # drop the renderer's spare trailing frame
        gt = gt[:len(frames)]
        sequences.append({"frames": frames, "gt": _xyxy_to_xywh(gt)})

    # an npz, a siam_train_main directory, an upstream .pth, or seeded weights
    tracker = build_siam_reasoner(weights, device=device).tracker
    result = evaluate_tracker(tracker, sequences)
    result.pop("per_sequence", None)
    return result


def existing_set(root: Path, src: Path, videos: Path, limit) -> dict:
    """The directories of an existing split; with `limit`, symlink farms of
    its first `limit` videos by name, so that every driver sees the same
    subset."""
    if not limit:
        return {"scenes": src / "scenes", "labels": src / "labels",
                "videos": videos, "perception": src / "od_perception"}
    names = sorted(p.stem for p in videos.glob("*.avi"))[:limit]
    sub = root / "subset"
    for tag, src_dir, patterns in (
            ("videos", videos, ["{}.avi"]),
            ("labels", src / "labels", ["{}_bb.json"]),
            ("od_perception", src / "od_perception", ["{}.pkl"]),
            ("scenes", src / "scenes", ["{}.json"])):
        d = sub / tag
        d.mkdir(parents=True, exist_ok=True)
        for n in names:
            for pat in patterns:
                f = pat.format(n)
                link = d / f
                if not link.exists() and (src_dir / f).exists():
                    link.symlink_to(src_dir / f)
    return {"scenes": sub / "scenes", "labels": sub / "labels",
            "videos": sub / "videos", "perception": sub / "od_perception"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path("data/trackbench"))
    ap.add_argument("--videos", type=int, default=12)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--weights", type=str, default="",
                    help="SiamRPN weights: an .npz, a siam_train_main "
                         "directory or an upstream .pth; seeded if empty")
    ap.add_argument("--existing-src", type=Path, default=None,
                    help="reuse an existing split dir (scenes/ labels/ "
                         "od_perception/) instead of building a fixture set")
    ap.add_argument("--existing-videos", type=Path, default=None,
                    help="rendered videos dir matching --existing-src")
    ap.add_argument("--limit", type=int, default=None,
                    help="with --existing-src: use only the first N videos")
    ap.add_argument("--resume", action="store_true",
                    help="reuse finished <name>_bb.json results in --root "
                         "(ONLY valid when re-running with the SAME weights)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where SiamRPN runs (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    args.root.mkdir(parents=True, exist_ok=True)
    if args.existing_src is not None:
        dirs = existing_set(args.root, args.existing_src, args.existing_videos, args.limit)
        print(f"[bench] using existing set: {len(list(dirs['videos'].glob('*.avi')))} "
              f"videos", flush=True)
    else:
        print("[bench] building rendered fixture set...", flush=True)
        dirs = build_fixture_set(args.root, args.videos, args.frames)

    results = {}
    for model_type in MODELS:
        print(f"[bench] {model_type}...", flush=True)
        results[model_type] = reasoner_ope(args.root, dirs, model_type,
                                           args.weights, args.resume, device)
    print("[bench] raw siamrpn (OTB harness)...", flush=True)
    results["siamrpn_raw"] = raw_siam_ope(dirs, args.weights, device)

    print(f"{'model':24s} {'success AUC':>12s} {'prec@20px':>10s} "
          f"{'mean IoU':>9s}")
    for name, m in results.items():
        print(f"{name:24s} {m['success_auc']:12.3f} "
              f"{m['precision_20px']:10.3f} {m['mean_iou']:9.3f}")
    (args.root / "results.json").write_text(json.dumps(results, indent=2))
    print(f"[bench] wrote {args.root / 'results.json'}")


if __name__ == "__main__":
    main()
