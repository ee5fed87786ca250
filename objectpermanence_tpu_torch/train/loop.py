"""The training loop, the counterpart of `objectpermanence_tpu/train/loop.py`.

- The train step is forward, loss, backward and an Adam update. Every
  model's forward runs layer by layer (`forward_layers`), so on the card
  its LSTMs run on the recurrence kernels: K2 forward and K3 backward in
  the train step, the forward-only K4 in the eval step. The fused inference
  kernel (K1) is never used here. The train step adds `opnet_moe`'s
  balance term and `opnet_att_ce`'s attention cross-entropy by their spec
  weights, and runs dropout (`transformer_lstm`) from a generator seeded
  from the training seed; the eval step runs the model in eval mode,
  without dropout.
- Datasets are resident on the device; batches are gathered there by index.
  `batch_indices` shuffles with `RandomState(seed + epoch)` and pads the
  last batch by repeating its last row, exactly as the JAX loop, so the
  same videos land in the same batches; padded rows carry zero weight in
  the train loss and count, unweighted, in the eval loss, as there.
- Epoch-end evaluation (int32 pixel boxes -> per-video mean IoU ->
  containment mIoU) runs on the device.
- One card, no mesh: the batch is not rounded to a data-parallel width.
- Checkpoints: the best-dev params as `<ckpt>/<model>/<dd-mm-yy>_<miou>.npz`
  and a resumable state per epoch under `<ckpt>/<model>/resume/epoch_NNNN/`.
- Observability: `profile_dir` traces the first epoch's steps with
  torch.profiler, `debug_nans` runs under `torch.autograd.detect_anomaly`,
  `metrics_file` gets one json line per epoch; a NaN loss aborts.
"""

import contextlib
import json
import time
from dataclasses import dataclass
from datetime import date
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.config import TrainingConfig, config_device, training_config_from
from objectpermanence_tpu_torch.data.ingest import IngestedDataset
from objectpermanence_tpu_torch.models.moe import moe_balance_loss
from objectpermanence_tpu_torch.models.registry import ModelSpec
from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes, iou_xyxy
from objectpermanence_tpu_torch.train.losses import attention_ce_loss, total_loss
from objectpermanence_tpu_torch.train.plateau import ReduceLROnPlateau
from objectpermanence_tpu_torch.utils import checkpoint as ckpt


def make_optimizer(params, learning_rate: float) -> torch.optim.Adam:
    """Adam with torch's defaults (betas 0.9/0.999, eps 1e-8), as optax.adam
    in the JAX loop; the plateau scheduler sets the rate in `param_groups`."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _fp32_products(device: torch.device) -> None:
    """fp32 parity with the reference: no TF32 in matmuls or cuDNN."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _forward(spec: ModelSpec, model, boxes, generator=None, weights=None):
    """-> (boxes, who-to-attend logits or None, balance term or None), as
    JAX's `_forward`: the balance term where the spec weighs one (its token
    weights the sample weights), the logits for the double-output models."""
    if spec.aux_loss_weight:
        out, logits, probs = model.forward_layers(boxes, generator, return_probs=True)
        return out, logits, moe_balance_loss(probs, token_weight=weights)
    if spec.double_output:
        out, logits = model.forward_layers(boxes, generator)
        return out, logits, None
    return model.forward_layers(boxes, generator), None, None


def make_train_step(spec: ModelSpec, optimizer: torch.optim.Optimizer, generator=None):
    """`train_step(model, boxes, labels, mask, weights=None, tracks=None)`
    -> metrics (0-d tensors); updates `model` in place. `weights (B,)` is 0
    on the repeated rows that pad a ragged batch. Dropout, where the model
    has it, runs in train mode from `generator` (on the model's device).
    Gradients stay in `param.grad` until the next step."""

    def train_step(model, boxes, labels, mask, weights=None, tracks=None):
        optimizer.zero_grad(set_to_none=True)
        out, logits, aux = _forward(spec, model, boxes, generator, weights)
        loss, metrics = total_loss(out, labels, mask, spec.no_labels, sample_weight=weights)
        if aux is not None:
            loss = loss + spec.aux_loss_weight * aux
            metrics = {**metrics, "loss": loss, "balance_loss": aux}
        if spec.att_ce_weight and tracks is not None:
            att_ce = attention_ce_loss(logits, tracks, sample_weight=weights)
            loss = loss + spec.att_ce_weight * att_ce
            metrics = {**metrics, "loss": loss, "att_ce_loss": att_ce}
        loss.backward()
        optimizer.step()
        return {key: value.detach() for key, value in metrics.items()}

    return train_step


def make_eval_step(spec: ModelSpec):
    """`eval_step(model, boxes, labels, mask)` -> (loss pieces, per-video
    mean IoU, per-video IoU sum over masked frames, masked frame count)."""

    @torch.no_grad()
    def eval_step(model, boxes, labels, mask):
        out = model.forward_layers(boxes)
        if spec.double_output:
            out = out[0]
        _, metrics = total_loss(out, labels, mask, spec.no_labels)
        # the reference truncates to int32 pixels before the IoU
        iou = iou_xyxy(denormalize_boxes(out).float(), denormalize_boxes(labels).float())
        video_mean_iou = iou.mean(dim=1)                            # (B,)
        frame_mask = mask.sum(dim=-1) > 0                           # (B, T)
        masked_frames = frame_mask.sum(dim=1)                       # (B,)
        masked_iou_sum = (iou * frame_mask).sum(dim=1)
        return metrics, video_mean_iou, masked_iou_sum, masked_frames

    return eval_step


class DeviceDataset:
    """A dataset resident on the device; batches are gathered there by index."""

    def __init__(self, dataset: IngestedDataset, device):
        self.count = len(dataset)
        self.device = torch.device(device)
        self.boxes = torch.from_numpy(dataset.boxes).to(self.device)
        self.labels = torch.from_numpy(dataset.labels).to(self.device)
        mask = (dataset.containment_mask if dataset.containment_mask is not None
                else np.zeros(dataset.labels.shape, dtype=bool))
        self.mask = torch.from_numpy(mask).to(self.device)
        tracks = (dataset.index_to_track if dataset.index_to_track is not None
                  else np.zeros(dataset.labels.shape[:2], dtype=np.int64))
        self.tracks = torch.from_numpy(np.asarray(tracks, np.int64)).to(self.device)

    def batch(self, indices: np.ndarray):
        idx = torch.as_tensor(indices, dtype=torch.long).to(self.device)
        return self.boxes[idx], self.labels[idx], self.mask[idx], self.tracks[idx]

    def batch_indices(self, batch_size: int, *, shuffle: bool = False, seed: int = 0):
        """Yield (padded index vector, real count) covering the dataset."""
        order = np.arange(self.count)
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for start in range(0, self.count, batch_size):
            sel = order[start:start + batch_size]
            real = len(sel)
            if real < batch_size:
                sel = np.concatenate([sel, np.repeat(sel[-1:], batch_size - real)])
            yield sel, real


def evaluate(eval_step, model, data: DeviceDataset, batch_size: int) -> Dict[str, float]:
    """Full-dataset eval: average loss, mean IoU, containment mIoU (over the
    videos with at least one containment frame)."""
    model.eval()
    total = 0
    loss_sum = 0.0
    video_ious, cont_sums, cont_counts = [], [], []
    for indices, real in data.batch_indices(batch_size):
        boxes, labels, mask, _ = data.batch(indices)
        metrics, vid_iou, c_sum, c_cnt = eval_step(model, boxes, labels, mask)
        loss_sum += float(metrics["loss"]) * real
        video_ious.append(vid_iou.cpu().numpy()[:real])
        cont_sums.append(c_sum.cpu().numpy()[:real])
        cont_counts.append(c_cnt.cpu().numpy()[:real])
        total += real
    model.train()

    video_ious = np.concatenate(video_ious)
    cont_sums = np.concatenate(cont_sums)
    cont_counts = np.concatenate(cont_counts)
    with_mask = cont_counts > 0
    containment_miou = (float(np.mean(cont_sums[with_mask] / cont_counts[with_mask]))
                        if with_mask.any() else 0.0)
    return {"loss": loss_sum / max(total, 1), "mean_iou": float(np.mean(video_ious)),
            "containment_mean_iou": containment_miou}


@dataclass
class TrainResult:
    model: torch.nn.Module
    best_dev_iou: float
    history: list


def _profiler(profile_dir: str, device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))


def training_main(spec: ModelSpec, train_dataset: IngestedDataset,
                  dev_dataset: IngestedDataset, train_config, model_config: Dict[str, int], *,
                  resume: bool = False, device=None) -> TrainResult:
    """Full training run with the reference's recipe
    (`configs/training_config.json`): Adam, plateau LR on the train loss,
    best-dev-mIoU checkpoints. `device` defaults to the config's: "cpu" is
    the CPU, anything else (the shipped "tpu" too) the card."""
    cfg: TrainingConfig = training_config_from(train_config)
    device = resolve_device(config_device(cfg.device) if device is None else device)
    _fp32_products(device)
    seed = cfg.seed
    batch_size = cfg.batch_size
    eval_batch_size = min(cfg.inference_batch_size,
                          max(len(train_dataset), len(dev_dataset), 1))

    train_data = DeviceDataset(train_dataset, device)
    dev_data = DeviceDataset(dev_dataset, device)

    model = spec.build(model_config, torch.Generator().manual_seed(seed)).to(device).train()
    optimizer = make_optimizer(model.parameters(), cfg.learning_rate)
    scheduler = ReduceLROnPlateau(lr=cfg.learning_rate, factor=cfg.lr_scheduler_factor,
                                  patience=cfg.lr_scheduler_patience)

    start_epoch = 0
    # -1 so the first epoch always writes a best-dev checkpoint
    highest_dev_iou = -1.0
    ckpt_dir = Path(cfg.checkpoints_path) / spec.name
    if resume:
        latest = ckpt.latest_checkpoint(ckpt_dir / "resume")
        if latest is not None:
            meta = ckpt.restore_train_state(latest, model, optimizer)
            scheduler.load_state_dict(meta["scheduler"])
            for group in optimizer.param_groups:
                group["lr"] = scheduler.lr
            start_epoch = int(meta["epoch"])
            highest_dev_iou = float(meta["highest_dev_iou"])
            print(f"Resumed from {latest} at epoch {start_epoch}")

    # dropout's generator, seeded from the training seed (JAX: PRNGKey(seed + 1))
    generator = torch.Generator(device).manual_seed(seed + 1)
    train_step = make_train_step(spec, optimizer, generator)
    eval_step = make_eval_step(spec)

    history = []
    start_time = time.time()
    metrics_path = Path(cfg.metrics_file) if cfg.metrics_file else None
    anomaly = torch.autograd.detect_anomaly() if cfg.debug_nans else contextlib.nullcontext()

    with anomaly:
        for epoch in range(start_epoch, cfg.num_epochs):
            epoch_num = epoch + 1
            profiler = (_profiler(cfg.profile_dir, device)
                        if cfg.profile_dir is not None and epoch == start_epoch else None)
            if profiler is not None:
                profiler.start()
            epoch_start = time.time()
            running = {"loss": 0.0, "pred_loss": 0.0, "consistency_loss": 0.0}
            pending = []  # metrics stay on the device until they are printed

            for batch_idx, (indices, real) in enumerate(
                    train_data.batch_indices(batch_size, shuffle=True, seed=seed + epoch), 1):
                boxes, labels, mask, tracks = train_data.batch(indices)
                weights = torch.from_numpy(
                    (np.arange(batch_size) < real).astype(np.float32)).to(device)
                pending.append(train_step(model, boxes, labels, mask, weights, tracks))

                if batch_idx % cfg.print_step == 0:
                    for m in pending:
                        for key in running:
                            running[key] += float(m[key])
                    pending = []
                    if not np.isfinite(running["loss"]):
                        raise RuntimeError(f"Loss is {running['loss'] / cfg.print_step}, "
                                           f"stopping training")
                    elapsed = int(time.time() - start_time)
                    print(f"Train Epoch: {epoch_num} [{batch_idx * batch_size}/"
                          f"{len(train_dataset)}]\t Average Loss: Total "
                          f"{running['loss'] / cfg.print_step:.4f}, Pred "
                          f"{running['pred_loss'] / cfg.print_step:.4f} Consistent "
                          f"{running['consistency_loss'] / cfg.print_step:.4f} "
                          f"Training began {elapsed} seconds ago")
                    running = {k: 0.0 for k in running}

            if profiler is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()

            train_metrics = evaluate(eval_step, model, train_data, eval_batch_size)
            dev_metrics = evaluate(eval_step, model, dev_data, eval_batch_size)
            if not np.isfinite(train_metrics["loss"]):
                raise RuntimeError(f"Loss is {train_metrics['loss']}, stopping training")
            print(f"Epoch {epoch_num} Training Set: Loss {train_metrics['loss']:.4f}, "
                  f"Mean IoU {train_metrics['mean_iou']:.6f}, "
                  f"Mask Mean Iou {train_metrics['containment_mean_iou']:.6f}")
            print(f"Epoch {epoch_num} Dev Set: Loss {dev_metrics['loss']:.4f}, "
                  f"Mean IoU {dev_metrics['mean_iou']:.6f}, "
                  f"Mask Mean Iou {dev_metrics['containment_mean_iou']:.6f}")
            epoch_record = {"epoch": epoch_num, "train": train_metrics, "dev": dev_metrics,
                            "epoch_seconds": round(time.time() - epoch_start, 2),
                            "learning_rate": scheduler.lr}
            history.append(epoch_record)
            if metrics_path is not None:
                with open(metrics_path, "a") as f:
                    f.write(json.dumps(epoch_record) + "\n")

            new_lr = scheduler.step(train_metrics["loss"])
            for group in optimizer.param_groups:
                group["lr"] = new_lr

            if dev_metrics["mean_iou"] > highest_dev_iou:
                highest_dev_iou = dev_metrics["mean_iou"]
                stamp = date.today().strftime("%d-%m-%y")
                ckpt.save_params(ckpt_dir / f"{stamp}_{round(highest_dev_iou, 3)}.npz",
                                 model.state_dict())
                print(f"Saved best model so far on dev set with type {spec.name} "
                      f"and performance mean IoU of: {round(highest_dev_iou, 3)}")

            ckpt.save_train_state(
                ckpt_dir / "resume" / f"epoch_{epoch_num:04d}", model, optimizer,
                {"epoch": epoch_num, "highest_dev_iou": highest_dev_iou,
                 "scheduler": scheduler.state_dict()})

    return TrainResult(model=model, best_dev_iou=highest_dev_iou, history=history)
