"""Batched reasoning inference, the counterpart of
`objectpermanence_tpu/infer/reasoning.py`: ingest -> batched forward on
the card -> integer pixel boxes -> per-video `<name>_bb.json`.

On CUDA the OPNet forward is the fused kernel (`ops/opnet_fused.py`), in
float32 or with bf16 operands (`make_predict_step(compute_dtype=...)`).
There is one card, so there is no mesh and no batch padding: the kernel
masks a ragged last batch itself.
"""

from pathlib import Path
from typing import Dict

import numpy as np
import torch

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.analysis.analyzer import write_bb_predictions
from objectpermanence_tpu_torch.config import config_device, inference_config_from
from objectpermanence_tpu_torch.data.ingest import IngestedDataset, batches, ingest_directory
from objectpermanence_tpu_torch.models.registry import ModelSpec, init_model
from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes


def make_predict_step(spec: ModelSpec, device=None, out_dtype=torch.int32,
                      compute_dtype=None):
    """`predict_step(model, boxes) -> (B, T, 4)` integer pixel boxes on
    `device` (the card unless "cpu"). `boxes` is a float32 array or tensor
    `(B, T, 15, F)`. `out_dtype` is int32, as the reference's output arrays,
    or int16, which holds 320x240 pixel coordinates exactly.

    `compute_dtype` (None: float32, or torch.bfloat16) picks the fused
    kernel's operands on the card, as JAX's picks its Pallas kernel's on the
    TPU: bf16 trades about a pixel of box precision for half the weight
    bytes. Off the card it is ignored, as JAX's CPU path ignores it: the
    plain forward runs in float32.

    On the card TF32 is switched off for matmuls and cuDNN, so the input
    projection outside the kernel keeps fp32 parity with the reference."""
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

    @torch.inference_mode()
    def predict_step(model, boxes):
        boxes = torch.as_tensor(boxes, dtype=torch.float32).to(device).contiguous()
        out = model(boxes, compute_dtype=fused_dtype)
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
        pred_px = predict_step(model, batch["boxes"]).cpu().numpy()
        for name, boxes in zip(batch["names"], pred_px):
            results[name] = boxes
    return results


def reasoning_inference_main(model_name: str, results_dir: str, inference_config,
                             model_config: Dict, device=None) -> Dict[str, np.ndarray]:
    """Full inference run: ingest -> batched forward -> per-video
    `<name>_bb.json` predictions. `device` defaults to the config's:
    "cpu" is the CPU, anything else (the shipped "tpu" too) the card."""
    cfg = inference_config_from(inference_config)
    device = resolve_device(config_device(cfg.device) if device is None else device)

    spec, model = init_model(model_name, model_config, checkpoint_path=cfg.model_path,
                             device=device)
    dataset = ingest_directory(cfg.sample_dir, cfg.labels_dir, spec.feature_width,
                               cache_dir=cfg.cache_dir)
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)

    predictions = predict_dataset(spec, model, dataset, cfg.batch_size, device)
    for name, boxes in predictions.items():
        write_bb_predictions(name, results_dir, boxes)
    if cfg.videos_dir:
        print("note: debug videos (videos_dir) are not ported yet; "
              "see ROADMAP.md, Next slices, item 4")
    return predictions
