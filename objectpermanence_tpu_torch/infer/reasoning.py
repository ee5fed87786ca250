"""Batched reasoning inference, the counterpart of
`objectpermanence_tpu/infer/reasoning.py`: ingest -> batched forward on
the card -> integer pixel boxes -> per-video `<name>_bb.json`.

On CUDA the dense OPNet's forward is the fused kernel (K1,
`ops/opnet_fused.py`), in float32 or with bf16 operands
(`make_predict_step(compute_dtype=...)`); every other model runs
`forward_layers`, whose LSTMs run on the forward-only recurrence kernel
(K4). There is one card, so there is no mesh and no batch padding.
"""

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.analysis.analyzer import write_bb_predictions
from objectpermanence_tpu_torch.config import config_device, inference_config_from
from objectpermanence_tpu_torch.data.ingest import IngestedDataset, batches, ingest_directory
from objectpermanence_tpu_torch.models.reasoning import OPNet
from objectpermanence_tpu_torch.models.registry import ModelSpec, init_model, model_class
from objectpermanence_tpu_torch.ops.boxes import FRAME_SHAPES, denormalize_boxes
from objectpermanence_tpu_torch.utils import trace


def fused_opnet_eligible(model_name: str) -> bool:
    """Whether the fused OPNet kernel (K1) computes this model: the dense
    OPNet (two LSTMs and a dense box head). `opnet_lstm_mlp` has no video
    LSTM and `opnet_moe` has experts for a head, so both take
    `forward_layers`, as in JAX."""
    return model_class(model_name) is OPNet


def make_predict_step(spec: ModelSpec, device=None, out_dtype=torch.int32,
                      compute_dtype=None):
    """`predict_step(model, boxes) -> (B, T, 4)` integer pixel boxes on
    `device` (the card unless "cpu"). `boxes` is a float32 array or tensor
    `(B, T, 15, F)`. `out_dtype` is int32, as the reference's output arrays,
    or int16, which holds 320x240 pixel coordinates exactly.

    `compute_dtype` (None: float32, or torch.bfloat16) picks the fused
    kernel's operands on the card, as JAX's picks its Pallas kernel's on the
    TPU: bf16 trades about a pixel of box precision for half the weight
    bytes. Off the card, and for the models K1 does not compute, it is
    ignored, as in JAX: they run in float32.

    On the card TF32 is switched off for matmuls and cuDNN, so the input
    projection outside the kernel keeps fp32 parity with the reference.

    A call is the root span `objperm.serve.predict`, whose id is the
    request's; `boxes` on the host is a blocking copy to the card
    (`objperm.host.h2d`)."""
    device = resolve_device(device)
    if out_dtype not in (torch.int16, torch.int32):
        raise ValueError(f"out_dtype must be torch.int16 or torch.int32, got {out_dtype}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be None, torch.float32 or torch.bfloat16, "
                        f"got {compute_dtype}")
    fused_dtype = torch.float32
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        fused_dtype = compute_dtype or torch.float32
    fused = fused_opnet_eligible(spec.name)

    @torch.inference_mode()
    def predict_step(model, boxes):
        with trace.span("objperm.serve.predict"):
            boxes = torch.as_tensor(boxes, dtype=torch.float32)
            with trace.h2d(boxes, device):
                boxes = boxes.to(device)
            boxes = boxes.contiguous()
            out = (model(boxes, compute_dtype=fused_dtype) if fused
                   else model.forward_layers(boxes))
            if spec.double_output:
                out = out[0]
            return denormalize_boxes(out, out_dtype)

    return predict_step


def predict_dataset(spec: ModelSpec, model, dataset: IngestedDataset, batch_size: int,
                    device=None) -> Dict[str, np.ndarray]:
    """Forward the whole dataset; returns {video_name: (T, 4) int32 boxes}."""
    predict_step = make_predict_step(spec, device)
    results: Dict[str, np.ndarray] = {}
    for batch in batches(dataset, batch_size):
        pred_px = predict_step(model, batch["boxes"])
        with trace.d2h(pred_px):
            pred_px = pred_px.cpu().numpy()
        for name, boxes in zip(batch["names"], pred_px):
            results[name] = boxes
    return results


def write_debug_video(video_path, out_path, predictions: np.ndarray,
                      labels: np.ndarray) -> None:
    """The prediction (yellow) and ground truth (blue) drawn on each frame of
    `video_path` into `out_path` (mp4v, 30 fps), as the reference renders
    them (`inference_main.py:227-254`). Needs cv2."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise RuntimeError(f"Unable to open video {video_path}")
    # cv2 reports one spurious extra frame (`tracking_utils.py:27-30`)
    num_valid = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) - 1
    writer = None
    for frame_idx in range(min(num_valid, len(predictions))):
        ok, frame = cap.read()
        if not ok:
            break
        if writer is None:
            h, w = frame.shape[:2]
            writer = cv2.VideoWriter(str(out_path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
        p = predictions[frame_idx]
        g = labels[frame_idx]
        cv2.rectangle(frame, (int(p[0]), int(p[1])), (int(p[2]), int(p[3])), (0, 255, 255), 3)
        cv2.rectangle(frame, (int(g[0]), int(g[1])), (int(g[2]), int(g[3])), (255, 0, 0), 3)
        writer.write(frame)
    cap.release()
    if writer is not None:
        writer.release()


def reasoning_inference_main(model_name: str, results_dir: str, inference_config,
                             model_config: Dict, device=None) -> Dict[str, np.ndarray]:
    """Full inference run: ingest -> batched forward -> per-video
    `<name>_bb.json` predictions, and a debug video of each one whose
    `<videos_dir>/<name>.avi` exists (only those named in `sample_file`,
    when given; reference `get_experiment_videos`, `inference_main.py:22-41`).
    `device` defaults to the config's: "cpu" is the CPU, anything else (the
    shipped "tpu" too) the card."""
    cfg = inference_config_from(inference_config)
    device = resolve_device(config_device(cfg.device) if device is None else device)

    spec, model = init_model(model_name, model_config, checkpoint_path=cfg.model_path,
                             device=device)
    dataset = ingest_directory(cfg.sample_dir, cfg.labels_dir, spec.feature_width,
                               cache_dir=cfg.cache_dir)
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)

    predictions = predict_dataset(spec, model, dataset, cfg.batch_size, device)
    labels_px = (dataset.labels * np.asarray(FRAME_SHAPES, dtype=np.float32)).astype(np.int32)
    labels_by_name = dict(zip(dataset.names, labels_px))
    debug_names = set(predictions)
    if cfg.sample_file:
        with open(cfg.sample_file) as f:
            debug_names &= {Path(line.strip()).stem for line in f if line.strip()}
    for name, boxes in predictions.items():
        write_bb_predictions(name, results_dir, boxes)
        if cfg.videos_dir and name in debug_names:
            video_path = Path(cfg.videos_dir) / f"{name}.avi"
            if video_path.exists():
                write_debug_video(video_path, results_dir / f"{name}_results.avi", boxes,
                                  labels_by_name[name])
    return predictions
