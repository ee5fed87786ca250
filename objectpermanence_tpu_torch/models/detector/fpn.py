"""Feature Pyramid Network, the counterpart of
`objectpermanence_tpu/models/detector/fpn.py`: 1x1 laterals and 3x3
outputs with biases, nearest x2 top-down, P6 = stride-2 subsample of P5.
Names as torchvision's `backbone.fpn` in its <=0.5 layout
(`inner_blocks.0.weight`, `layer_blocks.0.weight`)."""

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from objectpermanence_tpu_torch.models.detector.resnet import conv


class FPN(nn.Module):
    def __init__(self, in_channels: List[int], out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList([conv(c, out_channels, 1, bias=True)
                                           for c in in_channels])
        self.layer_blocks = nn.ModuleList([conv(out_channels, out_channels, 3, bias=True)
                                           for _ in in_channels])

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        """[C2..C5] -> [P2, P3, P4, P5, P6], all with out_channels channels."""
        laterals = [m(f) for m, f in zip(self.inner_blocks, features)]
        outs = [None] * len(laterals)
        last = outs[-1] = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            # padded sizes are multiples of 32, so each level is exactly twice
            # the one above it; there nearest-neighbour upsampling reads
            # source pixel i // 2 in torch as in jax.image.resize("nearest")
            last = laterals[i] + F.interpolate(last, size=laterals[i].shape[-2:],
                                               mode="nearest")
            outs[i] = last
        pyramid = [m(o) for m, o in zip(self.layer_blocks, outs)]
        # LastLevelMaxPool: a stride-2 max-pool of kernel 1 is a subsample
        pyramid.append(pyramid[-1][..., ::2, ::2])
        return pyramid
