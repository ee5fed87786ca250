"""Model registry, the counterpart of `objectpermanence_tpu/models/registry.py`:
the same name lists, and the factory for every learned model. The two
programmed models (`detector_tracker`, `detector_heuristic`) have no spec:
`infer/trackers.py` runs them.
"""

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional

import torch

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.models import reasoning

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

@dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable              # (config, generator) -> nn.Module
    feature_width: int           # input features per object slot
    double_output: bool          # returns (boxes, attention logits)
    no_labels: bool              # masked-loss training variant
    aux_loss_weight: float = 0.0  # MoE balance-term weight, opnet_moe only
    att_ce_weight: float = 0.0   # attention cross-entropy weight, opnet_att_ce only


def _base_name(name: str) -> str:
    if name.endswith("_no_labels"):
        return name[: -len("_no_labels")]
    if name == "opnet_att_ce":
        return "opnet"
    return name


# base name -> (module, input features per object slot, double output)
_ARCHS = {
    "baseline_lstm": (reasoning.BaselineLSTM, 5, False),
    "non_linear_lstm": (reasoning.NonLinearLSTM, 5, False),
    "transformer_lstm": (reasoning.TransformerLSTM, 5, False),
    "opnet": (reasoning.OPNet, 6, True),
    "opnet_lstm_mlp": (reasoning.OPNetLSTMMLP, 6, True),
    "opnet_moe": (reasoning.OPNetMoE, 6, True),
}


def model_class(name: str):
    """The module class that `name` builds, or None where the port builds none."""
    arch = _ARCHS.get(_base_name(name))
    return arch[0] if arch else None


def get_model_spec(name: str, config: Optional[Dict] = None) -> ModelSpec:
    """The spec of `name`. From `config` it takes, as the JAX registry does,
    `reference_compat` (transformer_lstm), `moe_balance_weight` (opnet_moe,
    else 0.01) and `att_ce_weight` (opnet_att_ce, else 1.0)."""
    base = _base_name(name)
    if base not in _ARCHS:
        raise ValueError(f"Unknown model name: {name!r}; supported: {TRAINING_SUPPORTED_MODELS}")
    config = config or {}
    build, width, double = _ARCHS[base]
    if base == "transformer_lstm" and config.get("reference_compat"):
        build = partial(build, reference_compat=True)
    aux = float(config.get("moe_balance_weight", 0.01)) if base == "opnet_moe" else 0.0
    att_ce = float(config.get("att_ce_weight", 1.0)) if name == "opnet_att_ce" else 0.0
    return ModelSpec(name=name, build=build, feature_width=width, double_output=double,
                     no_labels=name in NO_LABELS_MODELS, aux_loss_weight=aux,
                     att_ce_weight=att_ce)


def init_model(name: str, config: Dict[str, int], seed: int = 0,
               checkpoint_path: Optional[str] = None, device=None, train: bool = False):
    """Build `(spec, model)` on `device` (the card unless "cpu"), in eval
    mode or, with `train`, in train mode; weights from `seed`, or from a
    checkpoint: an npz leaf, a tree of `<stamp>_<dev_miou>.npz` leaves
    resolved to its best one, or a reference-trained torch `.pth`
    state_dict, renamed by `models/convert.py::state_dict_from_reference`."""
    device = resolve_device(device)
    spec = get_model_spec(name, config)
    model = spec.build(config, torch.Generator().manual_seed(seed))
    if checkpoint_path is not None and str(checkpoint_path).endswith(".pth"):
        from objectpermanence_tpu_torch.models.convert import state_dict_from_reference
        reference = torch.load(checkpoint_path, map_location="cpu")
        model.load_state_dict(state_dict_from_reference(name, reference, model.state_dict()))
        print(f"Converted reference checkpoint {checkpoint_path}")
    elif checkpoint_path is not None:
        from objectpermanence_tpu_torch.utils.checkpoint import (
            best_params_checkpoint, load_params,
        )
        resolved = best_params_checkpoint(checkpoint_path)
        if resolved is not None:
            checkpoint_path = resolved
        model.load_state_dict(load_params(checkpoint_path))
        print(f"Loaded model parameters from {checkpoint_path}")
    return spec, model.to(device).train(train)
