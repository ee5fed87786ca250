"""Typed configuration, the port's copy of `objectpermanence_tpu/config.py`
(the inference part).

The JSON files in the repository's `configs/` parse into dataclasses:
unknown keys fail loudly, missing keys get defaults or a clear error. Key
names are the same as the JAX package's.
"""

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

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
