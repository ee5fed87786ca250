"""Detector training loop, the counterpart of
`objectpermanence_tpu/train/detector_loop.py`.

The reference recipe (`object_detection/training.py`): SGD with momentum
0.9 and weight decay 5e-4, a linear warmup over the first epoch's first
iterations, evaluation after every epoch and a checkpoint on improvement;
gradients clipped to a global norm of 10, as the JAX package does for
training from scratch. Detection mAP comes from `analysis/detection_eval.py`.
Checkpoints are `.npz` state_dicts (`utils/checkpoint.py`).

With a mesh, data parallel over its data dim (JAX shards the image batches
over the mesh's data axis): the batch is rounded up to the data width, each
rank runs its slice of every batch, the model is under DDP
(`models/detector/training.py::data_parallel_detector`), and rank 0
evaluates and writes the checkpoints. Each rank owns whole images, so the
RoIAlign kernels (K7/K8) run per rank as on one device, where JAX's mesh
step takes its XLA gather path instead.
"""

import shutil
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.analysis.detection_eval import evaluate_detections
from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
from objectpermanence_tpu_torch.models.detector import anchors as anchor_lib
from objectpermanence_tpu_torch.models.detector.detector import (
    CaterDetector, Detector, DetectorConfig, check_supported, init_detector,
)
from objectpermanence_tpu_torch.models.detector.training import (
    data_parallel_detector, make_detector_train_step, trainable_tensors,
)
from objectpermanence_tpu_torch.parallel.mesh import batch_sharding, data_group, data_width
from objectpermanence_tpu_torch.utils import checkpoint as ckpt


def warmup_schedule(base_lr: float, warmup_iters: int, warmup_factor: float = 1e-3):
    """count -> learning rate: linear warmup from `base_lr * warmup_factor`
    to `base_lr` over `warmup_iters` updates, then `base_lr`; in float32, as
    JAX computes it."""
    def schedule(step: int) -> float:
        alpha = np.clip(np.float32(step) / np.float32(max(warmup_iters, 1)), np.float32(0),
                        np.float32(1))
        return float(np.float32(base_lr)
                     * (np.float32(warmup_factor) * (np.float32(1) - alpha) + alpha))
    return schedule


def evaluate_detector(detector: CaterDetector, dataset: DetectionDataset,
                      batch_size: int = 8) -> Dict[str, float]:
    """mAP, AP50 and AP75 of `detector` over `dataset`, each image once (the
    repeat-padded tail of the last batch is skipped by name)."""
    predictions, ground_truths = [], []
    seen = set()
    for batch in dataset.batches(batch_size):
        boxes, labels, scores, valid = detector(batch["images"])
        for i, name in enumerate(batch["names"]):
            if name in seen:  # repeat-padded tail
                continue
            seen.add(name)
            keep = valid[i]
            predictions.append({"boxes": boxes[i][keep], "labels": labels[i][keep],
                                "scores": scores[i][keep]})
            gt_keep = batch["gt_valid"][i]
            ground_truths.append({"boxes": batch["gt_boxes"][i][gt_keep],
                                  "labels": batch["gt_labels"][i][gt_keep]})
    return evaluate_detections(predictions, ground_truths)


def _epoch_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """The sampler's generator of one epoch, so a resumed run draws what an
    uninterrupted one would (JAX folds the epoch into its key)."""
    state = int(np.random.SeedSequence([seed + 1, epoch]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(state)


def train_detector(train_dataset: DetectionDataset,
                   eval_dataset: Optional[DetectionDataset],
                   config: DetectorConfig, *,
                   num_epochs: int = 40, batch_size: int = 2,
                   learning_rate: float = 5e-3, momentum: float = 0.9,
                   weight_decay: float = 5e-4, warmup_iters: int = 1000,
                   checkpoint_dir: str = "./checkpoints/detector",
                   print_step: int = 50, seed: int = 0, mesh=None,
                   init_params=None, resume: bool = False, device=None) -> Dict:
    """Train the detector on `train_dataset`, evaluating on `eval_dataset`
    after every epoch; on the card unless `device="cpu"`.

    `init_params` is an initial state_dict in the port's names (for example
    a torchvision `.pth` through `convert.load_torch_checkpoint`); without
    it, the seeded init. Writes `<checkpoint_dir>/best_<mAP>.npz` on each
    improvement, `final.npz` at the end, and after every epoch the resumable
    state `resume/epoch_NNNN/{state.npz, metadata.json}` (params, the frozen
    batch-norm tensors, SGD momentum, the update count), keeping only the
    newest. `resume=True` restarts after the latest such epoch. The loss
    stays on the device between fetches every `print_step` iterations, where
    a non-finite loss stops the run. Returns {"model", "params" (its
    state_dict), "history" (the epochs run in this call), "best_map"}.

    With `mesh` (`parallel/mesh.py::make_mesh`), every rank calls this with
    the same datasets and arguments and its own `device`; the losses in the
    history are the whole batches'."""
    check_supported(config)
    device = resolve_device(device)
    rows = None       # this rank's rows of each batch, the only images it loads
    if mesh is not None:
        width = data_width(mesh)
        batch_size = -(-batch_size // width) * width
        rows = batch_sharding(mesh, batch_size)
    rank = 0 if mesh is None else dist.get_rank()

    def barrier():
        if mesh is not None:
            dist.barrier(group=data_group(mesh))

    def fetch(losses):
        """The losses of the steps since the last fetch, on the host (the
        whole batches', averaged over the ranks)."""
        if not losses:
            return []
        stacked = torch.stack(losses)
        if mesh is not None:
            dist.all_reduce(stacked, group=data_group(mesh))
            stacked = stacked / width
        return stacked.tolist()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    model = Detector(config)
    if init_params is None:
        init_detector(model, seed)
    else:
        model.load_state_dict(init_params, strict=True)
    model = model.to(device).train()
    tensors = [t for _, t in trainable_tensors(model)]
    anchors = [torch.from_numpy(a).to(device) for a in anchor_lib.pyramid_anchors(
        config.feature_shapes(), config.strides, config.anchor_sizes)]

    steps_per_epoch = max(len(train_dataset) // batch_size, 1)
    schedule = warmup_schedule(learning_rate, min(warmup_iters, steps_per_epoch - 1)
                               if steps_per_epoch > 1 else 1)
    optimizer = torch.optim.SGD(tensors, lr=learning_rate, momentum=momentum,
                                weight_decay=weight_decay, dampening=0.0)
    train_step = make_detector_train_step(config, anchors, optimizer, schedule)

    checkpoint_dir = Path(checkpoint_dir)
    start_epoch = 0
    best_map = -1.0
    if resume:
        barrier()
        latest = ckpt.latest_checkpoint(checkpoint_dir / "resume")
        if latest is not None:
            meta = ckpt.restore_train_state(latest, model, optimizer)
            start_epoch = int(meta["epoch"])
            best_map = float(meta.get("best_map", -1.0))
            train_step.count = int(meta["count"])
            if rank == 0:
                print(f"Resumed detector training from {latest} "
                      f"(epoch {start_epoch}, best mAP {best_map:.4f})", flush=True)
    stepped = model if mesh is None else data_parallel_detector(model, config, anchors, mesh)
    history = []
    start = time.time()

    def to_device(array, dtype=None):
        return torch.as_tensor(array, dtype=dtype).to(device, non_blocking=True)

    for epoch in range(start_epoch, num_epochs):
        generator = _epoch_generator(seed, epoch, device)
        losses = []
        pending = []      # losses on the device; fetched at print boundaries
        for it, batch in enumerate(train_dataset.batches(
                batch_size, shuffle=True, seed=seed + epoch, rows=rows)):
            draw_rows = None if mesh is None else (rows.start, batch_size)
            parts = train_step(stepped, to_device(batch["images"]), to_device(batch["gt_boxes"]),
                               to_device(batch["gt_labels"], torch.int64),
                               to_device(batch["gt_valid"]), generator=generator,
                               draw_rows=draw_rows)
            # keep the loss on the device: a fetch here would wait for the
            # step (the NaN abort fires at print boundaries instead)
            pending.append(parts["loss"])
            if (it + 1) % print_step == 0:
                fetched = fetch(pending)
                pending = []
                if not np.all(np.isfinite(fetched)):
                    raise RuntimeError(f"Loss is {fetched}, stopping training")
                losses.extend(fetched)
                if rank == 0:
                    print(f"Epoch {epoch + 1} iter {it + 1}: "
                          f"loss {np.mean(losses[-print_step:]):.4f} "
                          f"({int(time.time() - start)}s)", flush=True)
        fetched = fetch(pending)
        if fetched and not np.all(np.isfinite(fetched)):
            raise RuntimeError(f"Loss is {fetched}, stopping training")
        losses.extend(fetched)

        metrics = {"epoch": epoch + 1, "train_loss": float(np.mean(losses)),
                   "train_losses": losses}
        if eval_dataset is not None:
            scores = [None]
            if rank == 0:
                detector = CaterDetector(config, state_dict=model.state_dict(), device=device)
                scores[0] = evaluate_detector(detector, eval_dataset)
            if mesh is not None:
                dist.broadcast_object_list(scores, group=data_group(mesh),
                                           group_src=0)
            metrics.update(scores[0])
            if rank == 0:
                print(f"Epoch {epoch + 1}: loss {metrics['train_loss']:.4f} "
                      f"mAP {metrics.get('mAP', 0):.4f} "
                      f"AP50 {metrics.get('AP50', 0):.4f}", flush=True)
            if metrics["mAP"] > best_map:
                best_map = metrics["mAP"]
                if rank == 0:
                    ckpt.save_params(checkpoint_dir / f"best_{round(best_map, 3)}.npz",
                                     model.state_dict())
        history.append(metrics)

        # epoch-granular resume state; only the newest is kept (the full
        # detector with its momentum is a few hundred MB)
        if rank == 0:
            state_dir = checkpoint_dir / "resume" / f"epoch_{epoch + 1:04d}"
            ckpt.save_train_state(state_dir, model, optimizer,
                                  {"epoch": epoch + 1, "best_map": best_map,
                                   "count": train_step.count})
            for old in (checkpoint_dir / "resume").iterdir():
                if old.is_dir() and old != state_dir:
                    shutil.rmtree(old)
        barrier()

    if rank == 0:
        ckpt.save_params(checkpoint_dir / "final.npz", model.state_dict())
    barrier()
    return {"model": model, "params": model.state_dict(), "history": history,
            "best_map": best_map}
