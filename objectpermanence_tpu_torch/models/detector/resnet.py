"""ResNet backbone with frozen batch-norm (or GroupNorm), the counterpart of
`objectpermanence_tpu/models/detector/resnet.py`.

`nn.Module`s named as torchvision's `backbone.body` (`conv1`, `bn1`,
`layer1.0.conv1`, ..., `layer2.0.downsample.0`), so a torchvision state_dict
loads with `load_state_dict(strict=True)`. ResNet v1.5: the stride sits on
`conv2` of a stage's first bottleneck. Convolutions pad `k // 2` on both
sides, as torch does and as the JAX package does by hand.

Mixed precision: parameters and buffers stay float32 masters; every layer
computes in its input's dtype, casting them first, as the JAX package casts
its parameter tree to `compute_dtype` (`cast_floating`). A bfloat16 input
so stays bfloat16 through the net; without the casts, torch's promotion
would take it back to float32 at the first norm. A float32 input skips the
casts, so a float32 layer costs the host what torch's own does (the
detector's train step waits on the host).
"""

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    """Batch-norm as a fixed affine map (torchvision `FrozenBatchNorm2d`):
    buffers `weight`, `bias`, `running_mean`, `running_var`, eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        weight, bias, mean, var = self.weight, self.bias, self.running_mean, self.running_var
        if x.dtype != weight.dtype:
            weight, bias, mean, var = (t.to(x.dtype) for t in (weight, bias, mean, var))
        w = weight * torch.rsqrt(var + self.eps)
        b = bias - mean * w
        return x * w[:, None, None] + b[:, None, None]


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` in its input's dtype."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` in its input's dtype."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def make_norm(channels: int, norm: str) -> nn.Module:
    """"frozen" (fine-tuning pretrained weights) or "group": GroupNorm with
    min(32, C) groups, the from-scratch choice."""
    if norm == "group":
        return GroupNorm(min(32, channels), channels, eps=1e-5)
    if norm == "frozen":
        return FrozenBatchNorm2d(channels)
    raise ValueError(f"backbone_norm must be 'frozen' or 'group', got {norm!r}")


def conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, norm: str):
        super().__init__()
        cout = width * 4
        self.conv1 = conv(cin, width, 1)
        self.bn1 = make_norm(width, norm)
        self.conv2 = conv(width, width, 3, stride)
        self.bn2 = make_norm(width, norm)
        self.conv3 = conv(width, cout, 1)
        self.bn3 = make_norm(cout, norm)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(conv(cin, cout, 1, stride), make_norm(cout, norm))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-50 by default; `layers`/`width` shrink it for tests.
    forward: (B, 3, H, W) -> [C2, C3, C4, C5] (strides 4..32)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 norm: str = "frozen"):
        super().__init__()
        self.num_stages = len(layers)
        self.conv1 = conv(3, width, 7, stride=2)
        self.bn1 = make_norm(width, norm)
        cin = width
        for stage, blocks in enumerate(layers):
            stage_width = width * (2 ** stage)
            mods = []
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                mods.append(Bottleneck(cin, stage_width, stride, norm))
                cin = stage_width * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        features = []
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            features.append(x)
        return features


def out_channels(layers: Sequence[int] = (3, 4, 6, 3), width: int = 64) -> List[int]:
    return [width * (2 ** s) * 4 for s in range(len(layers))]
