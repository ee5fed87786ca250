"""Model registry, the counterpart of `objectpermanence_tpu/models/registry.py`:
the same name lists, and the factory for the models ported so far.

The OPNet family (`opnet`, `opnet_no_labels`, `opnet_att_ce`) is
ported, for inference and training. Every other name the JAX package knows raises
NotImplementedError naming the ROADMAP.md item that ports it.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.models.reasoning import OPNet

PROGRAMMED_MODELS = ["detector_tracker", "detector_heuristic"]

TRAINING_SUPPORTED_MODELS_5_TRACKS = [
    "baseline_lstm", "baseline_lstm_no_labels",
    "non_linear_lstm", "non_linear_lstm_no_labels",
    "transformer_lstm", "transformer_lstm_no_labels",
]

TRAINING_SUPPORTED_MODELS_6_TRACKS = [
    "opnet", "opnet_no_labels",
    "opnet_lstm_mlp", "opnet_lstm_mlp_no_labels",
    "opnet_moe",
    "opnet_att_ce",
]

TRAINING_SUPPORTED_MODELS = TRAINING_SUPPORTED_MODELS_5_TRACKS + TRAINING_SUPPORTED_MODELS_6_TRACKS

INFERENCE_SUPPORTED_MODELS = PROGRAMMED_MODELS + TRAINING_SUPPORTED_MODELS

DOUBLE_OUTPUT_MODELS = TRAINING_SUPPORTED_MODELS_6_TRACKS

NO_LABELS_MODELS = [m for m in TRAINING_SUPPORTED_MODELS if m.endswith("_no_labels")]

# where each model that is not ported yet is planned (ROADMAP.md, "Next slices")
_NOT_PORTED = {
    "baseline_lstm": "Next slices, item 3 (the other reasoning models)",
    "non_linear_lstm": "Next slices, item 3 (the other reasoning models)",
    "transformer_lstm": "Next slices, item 3 (the other reasoning models)",
    "opnet_lstm_mlp": "Next slices, item 3 (the other reasoning models)",
    "opnet_moe": "Next slices, item 3 (the other reasoning models)",
    "detector_tracker": "Next slices, item 6 (trackers and the heuristic)",
    "detector_heuristic": "Next slices, item 6 (trackers and the heuristic)",
}


@dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable              # (config, generator) -> nn.Module
    feature_width: int           # input features per object slot
    double_output: bool          # returns (boxes, attention logits)
    no_labels: bool              # masked-loss training variant
    att_ce_weight: float = 0.0   # attention cross-entropy weight, opnet_att_ce only


def _base_name(name: str) -> str:
    if name.endswith("_no_labels"):
        return name[: -len("_no_labels")]
    if name == "opnet_att_ce":
        return "opnet"
    return name


def get_model_spec(name: str, config: Optional[Dict] = None) -> ModelSpec:
    base = _base_name(name)
    if base in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet: see ROADMAP.md, {_NOT_PORTED[base]}")
    if base != "opnet":
        raise ValueError(f"Unknown model name: {name!r}; supported: {TRAINING_SUPPORTED_MODELS}")
    att_ce = float((config or {}).get("att_ce_weight", 1.0)) if name == "opnet_att_ce" else 0.0
    return ModelSpec(name=name, build=OPNet, feature_width=6, double_output=True,
                     no_labels=name in NO_LABELS_MODELS, att_ce_weight=att_ce)


def init_model(name: str, config: Dict[str, int], seed: int = 0,
               checkpoint_path: Optional[str] = None, device=None, train: bool = False):
    """Build `(spec, model)` on `device` (the card unless "cpu"), in eval
    mode or, with `train`, in train mode; weights from `seed`, or from an
    npz checkpoint: a leaf file or a tree of `<stamp>_<dev_miou>.npz`
    leaves resolved to its best one. `opnet_att_ce` takes its weight from
    `config["att_ce_weight"]`, else 1.0, as the JAX registry does."""
    device = resolve_device(device)
    spec = get_model_spec(name, config)
    model = spec.build(config, torch.Generator().manual_seed(seed))
    if checkpoint_path is not None:
        from objectpermanence_tpu_torch.utils.checkpoint import (
            best_params_checkpoint, load_params,
        )
        resolved = best_params_checkpoint(checkpoint_path)
        if resolved is not None:
            checkpoint_path = resolved
        model.load_state_dict(load_params(checkpoint_path))
        print(f"Loaded model parameters from {checkpoint_path}")
    return spec, model.to(device).train(train)
