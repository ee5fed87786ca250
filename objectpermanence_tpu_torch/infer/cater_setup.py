"""CATER-setup inference, the counterpart of
`objectpermanence_tpu/infer/cater_setup.py` (the CLI's `cater_inference`
mode): predict every video's boxes on the card (for `opnet`, K1), take each
video's last predicted box, map its centre through the ground-plane
homography into the 36-way grid, and write `class_pred_results.csv`."""

from pathlib import Path
from typing import Dict

import numpy as np
import pandas as pd

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.config import config_device, inference_config_from
from objectpermanence_tpu_torch.data.ingest import ingest_directory
from objectpermanence_tpu_torch.infer.reasoning import predict_dataset
from objectpermanence_tpu_torch.models.registry import init_model
from objectpermanence_tpu_torch.ops.homography import grid_classes_for_centers


def cater_setup_inference(model_name: str, results_dir: str, inference_config,
                          model_config: Dict, device=None) -> pd.DataFrame:
    """-> the written table: `video_names` (`<name>.avi`) and
    `class_predictions`. `device` defaults to the config's: "cpu" is the
    CPU, anything else the card."""
    cfg = inference_config_from(inference_config)
    device = resolve_device(config_device(cfg.device) if device is None else device)
    spec, model = init_model(model_name, model_config, checkpoint_path=cfg.model_path,
                             device=device)
    dataset = ingest_directory(cfg.sample_dir, cfg.labels_dir, spec.feature_width,
                               cache_dir=cfg.cache_dir)
    predictions = predict_dataset(spec, model, dataset, cfg.batch_size, device)

    names = list(predictions)
    last_boxes = np.stack([predictions[n][-1] for n in names]).astype(np.float64)
    centers = np.stack([(last_boxes[:, 0] + last_boxes[:, 2]) / 2,
                        (last_boxes[:, 1] + last_boxes[:, 3]) / 2], axis=-1)
    results_df = pd.DataFrame({"video_names": [f"{n}.avi" for n in names],
                               "class_predictions": grid_classes_for_centers(centers)})
    results_dir = Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    results_df.to_csv(results_dir / "class_pred_results.csv", index=False)
    return results_df
