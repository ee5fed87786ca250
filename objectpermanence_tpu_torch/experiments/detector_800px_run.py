"""Reference-geometry (800 px) detector ACCURACY run on the port, the
counterpart of `scripts/detector_800px_run.py`.

The reference fine-tunes Faster R-CNN at torchvision's min_size=800
geometry (its `object_detection/training.py`); the two-stage run uses the
native 320x240 CATER resolution. This driver trains at BOTH geometries on
the SAME rendered frame set (`roi_backend="windowed"` gives the 800 px
recipe the windowed RoIAlign kernel, with the exact backward) and reports
held-out mAP, train-step latency, and the windowed kernel's out-of-contract
roi rate for real training proposals.

Stages (resumable):
    python -m objectpermanence_tpu_torch.experiments.detector_800px_run render     # host, frames only
    python -m objectpermanence_tpu_torch.experiments.detector_800px_run steptime   # step-ms table
    python -m objectpermanence_tpu_torch.experiments.detector_800px_run train800   # 800 px windowed
    python -m objectpermanence_tpu_torch.experiments.detector_800px_run native     # native control
    python -m objectpermanence_tpu_torch.experiments.detector_800px_run contract   # contract rates

Every stage but `render` runs on the card (`--device cpu`: the CPU). The
windowed kernel counts its out-of-contract rois on the card, so
`train800`'s report holds real rates; `contract` re-derives them from the
trained checkpoint's proposals with `windowed_out_of_contract_mask`,
without launching the windowed kernel.
"""

import argparse
import json
import time
from pathlib import Path

import torch

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
from objectpermanence_tpu_torch.datagen.renderer import render_dataset
from objectpermanence_tpu_torch.models.detector import anchors as anchor_lib
from objectpermanence_tpu_torch.models.detector.detector import (
    CaterDetector, Detector, DetectorConfig, forward_features, init_detector, preprocess_images,
    propose, roi_path,
)
from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES, assign_levels
from objectpermanence_tpu_torch.models.detector.training import (
    make_detector_train_step, trainable_tensors,
)
from objectpermanence_tpu_torch.ops import roi_align_window
from objectpermanence_tpu_torch.ops.nms import NEG_INF
from objectpermanence_tpu_torch.train.detector_loop import evaluate_detector, train_detector
from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint

SPLIT_SCENES = {"train": 1600, "dev": 150, "test": 300}


def _config(geometry: str, roi_backend: str, compute_dtype: str = "float32") -> DetectorConfig:
    if geometry == "800":
        # the reference's torchvision geometry; proposal counts stay at the
        # two-stage recipe (500/300) so geometry is the only variable
        return DetectorConfig(min_size=800, max_size=1333,
                              backbone_norm="group", rpn_pre_nms_top_n=500,
                              rpn_post_nms_top_n=300, roi_backend=roi_backend,
                              compute_dtype=compute_dtype)
    return DetectorConfig(min_size=240, max_size=320, backbone_norm="group",
                          rpn_pre_nms_top_n=500, rpn_post_nms_top_n=300,
                          roi_backend=roi_backend,
                          compute_dtype=compute_dtype)


def render(src: Path, root: Path, det_samples: int) -> None:
    for i, (split, n) in enumerate(SPLIT_SCENES.items()):
        scenes_src = src / split / "scenes"
        subset = root / split / "scenes_subset"
        subset.mkdir(parents=True, exist_ok=True)
        for p in sorted(scenes_src.glob("*.json"))[:n]:
            link = subset / p.name
            if not link.exists():
                link.symlink_to(p)
        t0 = time.time()
        render_dataset(subset, src / split / "labels", root / split,
                       detection_samples_per_video=det_samples,
                       seed=2000 + i, progress_every=400, frames_only=True)
        k = len(list((root / split / "det_images").glob("*.png")))
        print(f"[render] {split}: {k} frames ({time.time()-t0:.0f}s)",
              flush=True)


def _datasets(root: Path):
    return {s: DetectionDataset(root / s / "det_images",
                                root / s / "detection_annotations.csv")
            for s in SPLIT_SCENES}


def seconds_per_call(fn, calls: int, device: torch.device) -> float:
    """Seconds per call of `fn` over `calls` chained calls: by CUDA events
    on the card, by the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls


# each row's RoIAlign on the port: JAX's "800px_gather" is its XLA gather,
# which the port computes with the exact kernel (K7 forward, K8 backward)
STEPTIME_ROWS = (("800px_windowed", "800", "windowed", 4),
                 ("800px_gather", "800", "gather", 4),
                 ("native_pallas", "native", "auto", 8))


def steptime(root: Path, steps: int, device=None) -> None:
    """Train-step latency at both geometries (and both 800 px RoI paths),
    over `steps` chained steps after 3 of warmup (timed by CUDA events on
    the card). Plain SGD (lr 5e-3, momentum 0.9, no clipping), as JAX's."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ds = DetectionDataset(root / "train" / "det_images",
                          root / "train" / "detection_annotations.csv")
    rows = {}
    for name, geometry, backend, batch in STEPTIME_ROWS:
        config = _config(geometry, backend)
        model = init_detector(Detector(config)).to(device).train()
        anchors = [torch.from_numpy(a).to(device) for a in anchor_lib.pyramid_anchors(
            config.feature_shapes(), config.strides, config.anchor_sizes)]
        optimizer = torch.optim.SGD([t for _, t in trainable_tensors(model)], lr=5e-3,
                                    momentum=0.9)
        step = make_detector_train_step(config, anchors, optimizer, lambda count: 5e-3,
                                        max_norm=float("inf"))
        batch_data = next(ds.batches(batch, shuffle=True, seed=0))
        args = [torch.as_tensor(batch_data[k]).to(device) for k in
                ("images", "gt_boxes", "gt_labels", "gt_valid")]
        args[2] = args[2].to(torch.int64)
        generator = torch.Generator(device=device).manual_seed(1)

        def run():
            return step(model, *args, generator=generator)

        for _ in range(3):  # warmup
            parts = run()
        float(parts["loss"])
        ms = seconds_per_call(run, steps, device) * 1000
        rows[name] = {"step_ms": round(ms, 3), "batch": batch,
                      "imgs_per_s": round(batch / ms * 1000, 2),
                      "roi_path": roi_path(config, device, needs_grad=True)}
        print(f"[steptime] {name}: {rows[name]}", flush=True)
        del model, optimizer, step
    (root / "steptime.json").write_text(json.dumps(rows, indent=2))


def _rate(c):
    return round(c["out_of_contract"] / c["rois"], 5) if c["rois"] else None


def train(root: Path, geometry: str, epochs: int, batch: int, lr: float,
          tag: str, compute_dtype: str = "float32", device=None) -> None:
    out = root / tag
    if (out / "report.json").exists():
        print(f"[{tag}] already complete", flush=True)
        return
    datasets = _datasets(root)
    config = _config(geometry, "windowed" if geometry == "800" else "auto",
                     compute_dtype)
    roi_align_window.reset_contract_stats()
    t0 = time.time()
    run = train_detector(datasets["train"], datasets["dev"], config,
                         num_epochs=epochs, batch_size=batch,
                         learning_rate=lr, checkpoint_dir=str(out),
                         print_step=200, resume=True, device=device)
    train_s = time.time() - t0
    train_contract = roi_align_window.contract_stats()

    roi_align_window.reset_contract_stats()
    best = best_params_checkpoint(out)
    detector = CaterDetector.load(str(best), config, device=device)
    test_metrics = evaluate_detector(detector, datasets["test"])
    eval_contract = roi_align_window.contract_stats()

    report = {"geometry": geometry, "epochs": epochs, "batch": batch,
              "compute_dtype": compute_dtype,
              "best_dev_map": run["best_map"], "test": test_metrics,
              "train_seconds": round(train_s),
              "train_contract": {**train_contract, "rate": _rate(train_contract)},
              "eval_contract": {**eval_contract, "rate": _rate(eval_contract)},
              "history": run["history"], "checkpoint": str(best)}
    (out / "report.json").write_text(json.dumps(report, indent=2))
    print(f"[{tag}] test {test_metrics} train_contract_rate "
          f"{_rate(train_contract)} eval_contract_rate {_rate(eval_contract)}",
          flush=True)


def contract(root: Path, tag: str, batches: int, batch: int, device=None) -> None:
    """Out-of-contract roi rates of the trained checkpoint, re-derived.
    Proposals precede pooling and so do not depend on the RoI path: this
    computes the rois that BOTH windowed dispatch points see with the
    trained weights (training: RPN proposals + gt, `models/detector/
    training.py`; inference: proposals, `models/detector/detector.py`) on
    the exact path and applies the windowed kernel's contract mask
    (`windowed_out_of_contract_mask`, the kernel's window geometry) on
    `device`; the entries are named after it (`train_contract_cpu`, as
    JAX's, or `train_contract_cuda`). No windowed kernel runs. Merges the
    rates into <tag>/report.json."""
    device = resolve_device(device)
    out = root / tag
    report_path = out / "report.json"
    config = _config("800", "gather")
    best = best_params_checkpoint(out)
    if best is None:
        print(f"[contract] no checkpoint under {out}", flush=True)
        return
    model = CaterDetector.load(str(best), config, device=device).model
    anchors = [torch.from_numpy(a).to(device) for a in anchor_lib.pyramid_anchors(
        config.feature_shapes(), config.strides, config.anchor_sizes)]
    h, w = config.padded_hw
    level_shapes = [(-(-h // s), -(-w // s), float(s)) for s in ROI_STRIDES]

    def mask_counts(rois, valid, pyramid):
        """(dispatched oow, dispatched total, valid oow, valid total):
        dispatched = every roi slot the windowed kernel would see (as its
        own counter counts); valid = only the rois that reach the output
        (NMS survivors, real gt rows), the rate that matters for accuracy."""
        m = roi_align_window.windowed_out_of_contract_mask(
            rois, assign_levels(rois), level_shapes, channels=config.fpn_channels,
            itemsize=pyramid[0].element_size())
        return int(m.sum()), m.numel(), int((m & valid).sum()), int(valid.sum())

    def features(images):
        return forward_features(model, preprocess_images(images, config))

    def train_counts(b):
        images, gt_boxes, gt_valid = (torch.as_tensor(b[k]).to(device)
                                      for k in ("images", "gt_boxes", "gt_valid"))
        pyramid = features(images)
        proposals, prop_scores = propose(model, pyramid, config, anchors)
        all_props = torch.cat([proposals, gt_boxes * config.scale], dim=1)
        valid = torch.cat([prop_scores > NEG_INF / 10, gt_valid], dim=1)
        return mask_counts(all_props, valid, pyramid)

    def eval_counts(b):
        pyramid = features(torch.as_tensor(b["images"]).to(device))
        proposals, prop_scores = propose(model, pyramid, config, anchors)
        return mask_counts(proposals, prop_scores > NEG_INF / 10, pyramid)

    ds = _datasets(root)
    stats = {}
    with torch.inference_mode():
        for name, split, fn in ((f"train_contract_{device.type}", "train", train_counts),
                                (f"eval_contract_{device.type}", "test", eval_counts)):
            oow = tot = voow = vtot = 0
            it = ds[split].batches(batch, shuffle=True, seed=3)
            for _ in range(batches):
                o, t, vo, vt = fn(next(it))
                oow += o
                tot += t
                voow += vo
                vtot += vt
            stats[name] = {"rois": tot, "out_of_contract": oow,
                           "rate": round(oow / tot, 5),
                           "valid_rois": vtot, "valid_out_of_contract": voow,
                           "valid_rate": round(voow / max(vtot, 1), 5)}
            print(f"[contract] {name}: {stats[name]}", flush=True)

    if report_path.exists():
        report = json.loads(report_path.read_text())
        report.update(stats)
        report_path.write_text(json.dumps(report, indent=2))
    else:
        out.mkdir(parents=True, exist_ok=True)
        (out / "contract.json").write_text(json.dumps(stats, indent=2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=["render", "steptime", "train800",
                                      "native", "contract"])
    ap.add_argument("--root", type=Path, default=Path("data/det800"))
    ap.add_argument("--src", type=Path, default=Path("data/sim2k"))
    ap.add_argument("--det-samples", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--compute-dtype", default="float32",
                    help="bfloat16 = mixed-precision training (float32 "
                         "masters; decode/NMS/loss stay float32)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every stage but render runs (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device) if args.stage != "render" else None
    args.root.mkdir(parents=True, exist_ok=True)
    if args.stage == "render":
        render(args.src, args.root, args.det_samples)
    elif args.stage == "steptime":
        steptime(args.root, args.steps, device)
    elif args.stage == "train800":
        train(args.root, "800", args.epochs, 4, args.lr, "det800",
              args.compute_dtype, device)
    elif args.stage == "native":
        train(args.root, "native", args.epochs, 8, args.lr, "detnative",
              args.compute_dtype, device)
    elif args.stage == "contract":
        contract(args.root, "det800", batches=4, batch=4, device=device)


if __name__ == "__main__":
    main()
