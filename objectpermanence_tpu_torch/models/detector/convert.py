"""Weight bridge for the detector, the port's copy of the torchvision key
mapping in `objectpermanence_tpu/models/detector/convert.py`.

The port's detector carries torchvision's `fasterrcnn_resnet50_fpn`
state_dict names in their <=0.5 layout (`backbone.fpn.inner_blocks.0.weight`,
`rpn.head.conv.weight`), torch layouts (conv OIHW, linear (out, in)), and
frozen batch-norm as `weight`, `bias`, `running_mean`, `running_var`.

- `state_dict_from_jax`: the JAX package's parameter tree (numpy leaves,
  e.g. from `jax.device_get`) -> the port's state_dict: conv HWIO -> OIHW,
  linear (in, out) -> (out, in); frozen BN `scale/bias/mean/var` ->
  `weight/bias/running_mean/running_var`, GroupNorm `scale/bias` ->
  `weight/bias`. Values are copied exactly.
- `torchvision_state_dict`: a torchvision `.pth` state_dict, raw or in the
  reference's `{"model_state_dict": ...}` wrapper, in the <=0.5 names or the
  newer nested ones (`fpn.inner_blocks.0.0.weight`,
  `rpn.head.conv.0.0.weight`) -> the port's names, without the BN
  `num_batches_tracked` counters; `load_state_dict(strict=True)` then
  catches any other difference in architecture.
- `export_torchvision_state_dict`: the inverse of `torchvision_state_dict`,
  the port's detector (or its state_dict) -> torchvision's <=0.5 names as
  numpy arrays in torch layout, which `torch.save` turns into a `.pth` that
  `CaterDetector.load` reads back.
"""

import re
from collections import OrderedDict
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

RESNET50_LAYERS = (3, 4, 6, 3)

# the newer torchvision nesting of the FPN and RPN convs
_NESTED = [(re.compile(r"^(backbone\.fpn\.(?:inner|layer)_blocks\.\d+)\.0\.(weight|bias)$"),
            r"\1.\2"),
           (re.compile(r"^rpn\.head\.conv\.0\.0\.(weight|bias)$"), r"rpn.head.conv.\1")]


def _tensor(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, copy=True))


def state_dict_from_jax(params: Dict[str, Any],
                        layers: Sequence[int] = RESNET50_LAYERS) -> "OrderedDict[str, torch.Tensor]":
    """JAX detector params (`detector_init`'s tree) -> the port's state_dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put_conv(name, w):
        sd[name] = _tensor(np.asarray(w).transpose(3, 2, 0, 1))   # HWIO -> OIHW

    def put_norm(prefix, norm):
        sd[f"{prefix}.weight"] = _tensor(norm["scale"])
        sd[f"{prefix}.bias"] = _tensor(norm["bias"])
        if "mean" in norm:  # frozen BN; GroupNorm has scale and bias only
            sd[f"{prefix}.running_mean"] = _tensor(norm["mean"])
            sd[f"{prefix}.running_var"] = _tensor(norm["var"])

    def put_linear(name, lin):
        sd[f"{name}.weight"] = _tensor(np.asarray(lin["w"]).T)     # (in, out) -> (out, in)
        sd[f"{name}.bias"] = _tensor(lin["b"])

    backbone = params["backbone"]
    put_conv("backbone.body.conv1.weight", backbone["stem_conv"])
    put_norm("backbone.body.bn1", backbone["stem_bn"])
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            p = f"backbone.body.layer{stage + 1}.{b}"
            block = backbone["stages"][stage][b]
            for i in (1, 2, 3):
                put_conv(f"{p}.conv{i}.weight", block[f"conv{i}"])
                put_norm(f"{p}.bn{i}", block[f"bn{i}"])
            if "downsample" in block:
                put_conv(f"{p}.downsample.0.weight", block["downsample"]["conv"])
                put_norm(f"{p}.downsample.1", block["downsample"]["bn"])

    fpn = params["fpn"]
    for i in range(len(layers)):
        put_conv(f"backbone.fpn.inner_blocks.{i}.weight", fpn["lateral"][i])
        sd[f"backbone.fpn.inner_blocks.{i}.bias"] = _tensor(fpn["lateral_b"][i])
        put_conv(f"backbone.fpn.layer_blocks.{i}.weight", fpn["output"][i])
        sd[f"backbone.fpn.layer_blocks.{i}.bias"] = _tensor(fpn["output_b"][i])

    rpn = params["rpn"]
    put_conv("rpn.head.conv.weight", rpn["conv"])
    sd["rpn.head.conv.bias"] = _tensor(rpn["conv_b"])
    put_conv("rpn.head.cls_logits.weight", rpn["cls"])
    sd["rpn.head.cls_logits.bias"] = _tensor(rpn["cls_b"])
    put_conv("rpn.head.bbox_pred.weight", rpn["reg"])
    sd["rpn.head.bbox_pred.bias"] = _tensor(rpn["reg_b"])

    box_head = params["box_head"]
    put_linear("roi_heads.box_head.fc6", box_head["fc6"])
    put_linear("roi_heads.box_head.fc7", box_head["fc7"])
    put_linear("roi_heads.box_predictor.cls_score", box_head["cls"])
    put_linear("roi_heads.box_predictor.bbox_pred", box_head["reg"])
    return sd


def torchvision_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision detector state_dict (raw or `{"model_state_dict": ...}`,
    flat or nested names) -> the port's names."""
    if "model_state_dict" in state_dict:  # the reference's checkpoint wrapper
        state_dict = state_dict["model_state_dict"]
    out = {}
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        for pattern, repl in _NESTED:
            key = pattern.sub(repl, key)
        out[key] = torch.as_tensor(value)
    return out


def export_torchvision_state_dict(model_or_state_dict) -> Dict[str, np.ndarray]:
    """The port's detector (`Detector`, or its state_dict) -> torchvision's
    <=0.5-named state_dict as numpy arrays in torch layout, the JAX package's
    `export_torchvision_state_dict` for the port. The port's names are
    torchvision's, so this copies every tensor to the host; the frozen
    batch-norm statistics are kept, so that `CaterDetector.load` of the
    `.pth` that `torch.save` makes of it loads with `strict=True`."""
    state_dict = (model_or_state_dict.state_dict()
                  if isinstance(model_or_state_dict, torch.nn.Module) else model_or_state_dict)
    return {key: value.detach().cpu().numpy().copy() for key, value in state_dict.items()}


def load_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """A torchvision `.pth`/`.pt` checkpoint (the reference's fine-tuned
    wrapper included) -> the port's state_dict."""
    return torchvision_state_dict(torch.load(path, map_location="cpu", weights_only=True))
