"""Weight bridge between the JAX package's parameter pytrees and the port's
`state_dict`s.

A pytree of nested dicts of arrays (as numpy, e.g. from
`jax.device_get`) maps to a flat `state_dict` whose keys join the path
with dots: `{"att_lstm": {"w_ih": ...}}` <-> `"att_lstm.w_ih"`. Layouts are
the same on both sides (`w (in, out)`, LSTM `w_ih (D, 4H)`), so both
directions copy the values exactly, dtype included.
"""

from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(params: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Nested dict of arrays -> flat state_dict of CPU tensors."""
    state = OrderedDict()

    def walk(prefix, node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(f"{prefix}{key}.", node[key])
        else:
            state[prefix[:-1]] = torch.from_numpy(np.array(node, copy=True))

    walk("", params)
    return state


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flat state_dict -> nested dict of numpy arrays (the inverse)."""
    params: Dict[str, Any] = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().cpu().numpy().copy()
    return params
