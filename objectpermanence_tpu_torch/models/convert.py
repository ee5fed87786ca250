"""Weight bridges into the port's `state_dict`s: from the JAX package's
parameter pytrees (both ways), and from the reference's torch checkpoints.

A pytree of nested dicts and lists of arrays (as numpy, e.g. from
`jax.device_get`) maps to a flat `state_dict` whose keys join the path
with dots: `{"att_lstm": {"w_ih": ...}}` <-> `"att_lstm.w_ih"`, and a list
(the JAX stacked LSTMs and encoders) gives its items' indices, as an
`nn.ModuleList` does: `{"video_lstm": [{"w_ih": ...}, ...]}` <->
`"video_lstm.0.w_ih"`. Layouts are the same on both sides (`w (in, out)`,
LSTM `w_ih (D, 4H)`), so both directions copy the values exactly, dtype
included.

`state_dict_from_reference` renames and transposes a reference-trained
`.pth` state_dict (`baselines/learned_models.py`'s layer names), as the JAX
package's `models/convert_reasoning.py` does.
"""

from collections import OrderedDict
from typing import Any, Dict, List

import numpy as np
import torch


def params_from_jax(params: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Nested dicts and lists of arrays -> flat state_dict of CPU tensors."""
    state = OrderedDict()

    def walk(prefix, node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(f"{prefix}{key}.", node[key])
        elif isinstance(node, (list, tuple)):
            for index, item in enumerate(node):
                walk(f"{prefix}{index}.", item)
        else:
            state[prefix[:-1]] = torch.from_numpy(np.array(node, copy=True))

    walk("", params)
    return state


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat state_dict -> nested dicts of numpy arrays, with a list wherever
    every key of a level is an index (the inverse)."""
    params: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy().copy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {key: lists(value) for key, value in node.items()}
        if all(key.isdigit() for key in node):
            assert sorted(map(int, node)) == list(range(len(node))), sorted(node)
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(params)


class _Reference:
    """A reference state_dict, consumed key by key."""

    def __init__(self, state_dict: Dict[str, Any]):
        # the reference's training saves the bare state_dict; its detection
        # engine wraps one as {"model_state_dict": ...}
        if isinstance(state_dict.get("model_state_dict"), dict):
            state_dict = state_dict["model_state_dict"]
        self.sd = dict(state_dict)
        self.out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def take(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise KeyError(f"reference checkpoint is missing {key!r}; has {sorted(self.sd)}")
        return torch.as_tensor(self.sd.pop(key)).detach().to(torch.float32)

    def linear(self, ours: str, theirs: str, bias: bool = False) -> None:
        self.out[f"{ours}.w"] = self.take(f"{theirs}.weight").t()   # (out, in) -> (in, out)
        if bias:
            self.out[f"{ours}.b"] = self.take(f"{theirs}.bias")

    def lstm(self, ours: str, theirs: str, layers: List[int] = None) -> None:
        for i in (layers if layers is not None else [0]):
            prefix = ours if layers is None else f"{ours}.{i}"
            self.out[f"{prefix}.w_ih"] = self.take(f"{theirs}.weight_ih_l{i}").t()
            self.out[f"{prefix}.w_hh"] = self.take(f"{theirs}.weight_hh_l{i}").t()

    def encoder_layer(self, ours: str, theirs: str, w_in_shape) -> None:
        dim, _, heads, head_dim = w_in_shape
        self.out[f"{ours}.attn.w_in"] = self.take(
            f"{theirs}.self_attn.in_proj_weight").t().reshape(dim, 3, heads, head_dim)
        self.out[f"{ours}.attn.b_in"] = self.take(
            f"{theirs}.self_attn.in_proj_bias").reshape(3, heads, head_dim)
        self.linear(f"{ours}.attn.out", f"{theirs}.self_attn.out_proj", bias=True)
        self.linear(f"{ours}.ff1", f"{theirs}.linear1", bias=True)
        self.linear(f"{ours}.ff2", f"{theirs}.linear2", bias=True)
        for norm in ("norm1", "norm2"):
            self.out[f"{ours}.{norm}.scale"] = self.take(f"{theirs}.{norm}.weight")
            self.out[f"{ours}.{norm}.bias"] = self.take(f"{theirs}.{norm}.bias")


def _layers(template: Dict[str, torch.Tensor], prefix: str) -> List[int]:
    """The indices of a ModuleList's layers in a state_dict, `<prefix>.<i>.`."""
    return sorted({int(k[len(prefix) + 1:].split(".")[0]) for k in template
                   if k.startswith(prefix + ".")})


def state_dict_from_reference(model_name: str, state_dict: Dict[str, Any],
                              template: Dict[str, torch.Tensor]) -> "OrderedDict[str, torch.Tensor]":
    """A reference `.pth` state_dict -> the port's state_dict for
    `model_name`. `template` (the built model's `state_dict()`) gives the
    layer counts and shapes; any missing, extra or mis-shaped tensor raises,
    as in the JAX converter."""
    base = model_name[:-len("_no_labels")] if model_name.endswith("_no_labels") else model_name
    ref = _Reference(state_dict)
    if base in ("opnet", "opnet_lstm_mlp"):
        ref.lstm("att_lstm", "object_to_track_LSTM")
        ref.linear("att_head", "object_to_track_prediction")
        if base == "opnet":
            ref.lstm("video_lstm", "video_LSTM")
        else:
            ref.linear("hidden", "hidden_layer")
        ref.linear("box_head", "prediction_layer")
    elif base == "baseline_lstm":
        ref.lstm("video_lstm", "video_LSTM")
        ref.linear("box_head", "predictions_layer")
    elif base in ("non_linear_lstm", "transformer_lstm"):
        ref.linear("box_proj", "boxes_linear")
        for i in _layers(template, "encoder"):
            ref.encoder_layer(f"encoder.{i}", f"attention_encoder.layers.{i}",
                              template[f"encoder.{i}.attn.w_in"].shape)
        ref.lstm("video_lstm", "video_LSTM", _layers(template, "video_lstm"))
        ref.linear("box_head", "predictions_layer")
    else:
        raise ValueError(f"no reference checkpoint format exists for {model_name!r} "
                         f"(beyond-reference variant?)")
    if ref.sd:
        raise ValueError(f"unconsumed reference tensors: {sorted(ref.sd)} — "
                         f"checkpoint/model-name mismatch?")
    if set(ref.out) != set(template):
        raise ValueError(f"converted keys {sorted(ref.out)} != the model's {sorted(template)}")
    for key, value in ref.out.items():
        if tuple(value.shape) != tuple(template[key].shape):
            raise ValueError(f"converted tensor {key} has shape {tuple(value.shape)}, expected "
                             f"{tuple(template[key].shape)} — model config mismatch with the "
                             f"checkpoint")
    return OrderedDict((key, value.contiguous()) for key, value in ref.out.items())
