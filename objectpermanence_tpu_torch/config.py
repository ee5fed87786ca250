"""Typed configuration, the port's copy of `objectpermanence_tpu/config.py`
(the training, inference and preprocess parts).

The JSON files in the repository's `configs/` parse into dataclasses:
unknown keys fail loudly, missing keys get defaults or a clear error. Key
names are the same as the JAX package's.
"""

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

CONFIGS_DIR = Path(__file__).resolve().parent.parent / "configs"


class ConfigError(ValueError):
    pass


def _from_dict(cls, data: Dict[str, Any], name: str):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ConfigError(f"{name}: unknown config keys {sorted(unknown)}; "
                          f"supported: {sorted(fields)}")
    missing = [f.name for f in fields.values()
               if f.default is dataclasses.MISSING
               and f.default_factory is dataclasses.MISSING
               and f.name not in data]
    if missing:
        raise ConfigError(f"{name}: missing required config keys {missing}")
    return cls(**data)


def load_model_config(model_name: str) -> dict:
    """The shipped `configs/<model>_model_config.json`. Variants without a
    file of their own resolve to their base architecture's: `*_no_labels`
    (same net), `opnet_moe` and `opnet_att_ce` (OPNet's hyperparameters;
    `opnet_att_ce` adds its tuned `att_ce_weight` of 0.1)."""
    overlay = {}
    if model_name.endswith("_no_labels"):
        model_name = model_name[: -len("_no_labels")]
    elif model_name in ("opnet_moe", "opnet_att_ce"):
        if model_name == "opnet_att_ce":
            overlay = {"att_ce_weight": 0.1}
        model_name = "opnet"
    with open(CONFIGS_DIR / f"{model_name}_model_config.json") as f:
        return {**json.load(f), **overlay}


@dataclass(frozen=True)
class TrainingConfig:
    """Mirrors `configs/training_config.json`. `device` is "cpu" for the
    CPU; any other value (the shipped "tpu" included) means the CUDA card."""
    train_sample_dir: str
    train_labels_dir: str
    train_containment_file: str
    dev_sample_dir: str
    dev_labels_dir: str
    dev_containment_file: str
    batch_size: int = 16
    inference_batch_size: int = 400
    num_workers: int = 0            # accepted for config-file compatibility
    num_epochs: int = 160
    print_step: int = 100
    learning_rate: float = 1e-3
    lr_scheduler_patience: int = 2
    lr_scheduler_factor: float = 0.8
    device: str = ""
    checkpoints_path: str = "./checkpoints"
    cache_dir: Optional[str] = None
    seed: int = 0
    profile_dir: Optional[str] = None    # torch.profiler trace of the first epoch
    debug_nans: bool = False             # torch.autograd.detect_anomaly
    metrics_file: Optional[str] = None   # jsonl per-epoch metrics
    device_resident_data: bool = True    # accepted; datasets always live on the device

    def validate(self) -> "TrainingConfig":
        if self.batch_size < 1 or self.num_epochs < 1:
            raise ConfigError("batch_size and num_epochs must be >= 1")
        if not (0 < self.lr_scheduler_factor <= 1):
            raise ConfigError("lr_scheduler_factor must be in (0, 1]")
        return self


def training_config_from(data) -> TrainingConfig:
    if isinstance(data, TrainingConfig):
        return data.validate()
    return _from_dict(TrainingConfig, dict(data), "training_config").validate()


def config_device(device: str) -> str:
    """A config's `device` as a torch device name: "cpu" stays the CPU,
    anything else means the card."""
    return "cpu" if device == "cpu" else "cuda"


@dataclass(frozen=True)
class InferenceConfig:
    """Mirrors `configs/inference_config.json`. `device` is "cpu" for the
    CPU; any other value (the shipped "tpu" included) means the CUDA card."""
    sample_dir: str
    labels_dir: str
    batch_size: int = 16
    num_workers: int = 0
    device: str = ""
    model_path: Optional[str] = None
    videos_dir: Optional[str] = None
    sample_file: Optional[str] = None
    cache_dir: Optional[str] = None
    # tracker (detector_*) models only, accepted for config-file compatibility
    skip_existing: bool = False


def inference_config_from(data) -> InferenceConfig:
    if isinstance(data, InferenceConfig):
        return data
    return _from_dict(InferenceConfig, dict(data), "inference_config")


@dataclass(frozen=True)
class PreprocessConfig:
    """Mirrors `configs/preprocess_config.json`, less the detector's own
    fields. `device` is "cpu" for the CPU; any other value means the card."""
    videos_dir: str
    od_model_weights: Optional[str] = None
    batch_size: int = 16
    sample_file: Optional[str] = None
    pipeline_depth: int = 2         # videos decoded ahead of the card
    device: str = ""


def preprocess_config_from(data) -> Tuple[PreprocessConfig, Dict[str, Any]]:
    """A preprocess config -> (PreprocessConfig, DetectorConfig overrides):
    any `DetectorConfig` field may be set beside the run's own keys (lists
    become tuples); any other key fails."""
    from objectpermanence_tpu_torch.models.detector.detector import DetectorConfig
    data = dict(data)
    detector_fields = {f.name for f in dataclasses.fields(DetectorConfig)}
    overrides = {key: tuple(value) if isinstance(value, list) else value
                 for key, value in data.items() if key in detector_fields}
    run_keys = {key: value for key, value in data.items() if key not in detector_fields}
    cfg = _from_dict(PreprocessConfig, run_keys, "preprocess_config")
    if cfg.batch_size < 1 or cfg.pipeline_depth < 1:
        raise ConfigError("batch_size and pipeline_depth must be >= 1")
    return cfg, overrides
