"""Learned reasoning models, the counterpart of
`objectpermanence_tpu/models/reasoning.py`. This slice ports the OPNet
family (`opnet`, `opnet_no_labels` and `opnet_att_ce` share one net).

Input: `boxes (B, T, 15, 6)`, `[x1, y1, x2, y2, visible, is_cone]`
normalized by `[320, 240, 320, 240, 1, 1]`.
Output: `(y (B, T, 4), logits (B, 15, T))`: normalized snitch boxes and the
who-to-attend logits.
"""

from typing import Dict

import torch
from torch import nn

from objectpermanence_tpu_torch import MAX_OBJECTS_IN_FRAME
from objectpermanence_tpu_torch.ops.linear import Linear
from objectpermanence_tpu_torch.ops.lstm import LSTM
from objectpermanence_tpu_torch.ops.opnet_fused import opnet_fused_forward

BB_OUT_DIM = 4


class OPNet(nn.Module):
    """A who-to-attend LSTM over the flattened scene, softmax attention over
    the 15 object slots, soft selection of one box per frame, a video LSTM
    over the selected boxes and a linear box head. All layers bias-free;
    submodule and parameter names follow the JAX pytree (`att_lstm.w_ih`...).

    `forward` is the whole net as `ops/opnet_fused.py::opnet_fused_forward`:
    the fused kernel (K1) on CUDA tensors, its plain step loop on CPU
    tensors, with float32 or bfloat16 operands (`compute_dtype`); it is for
    inference and records no gradient. `forward_layers`
    is the same function layer by layer (`opnet_apply`), which the train and
    eval steps call: its LSTMs run on the recurrence kernels (K2/K3, or K4
    without a gradient) on CUDA tensors."""

    def __init__(self, config: Dict[str, int], generator: torch.Generator = None):
        super().__init__()
        feat = 6
        att_hidden = config["object_to_track_hidden_dim"]
        att_out = config["object_to_track_pred_dim"]
        vid_hidden = config["videos_hidden_dim"]
        self.att_lstm = LSTM(feat * MAX_OBJECTS_IN_FRAME, att_hidden, generator)
        self.att_head = Linear(att_hidden, att_out, generator)
        self.video_lstm = LSTM(feat, vid_hidden, generator)
        self.box_head = Linear(vid_hidden, BB_OUT_DIM, generator)

    def forward(self, boxes: torch.Tensor, compute_dtype: torch.dtype = torch.float32):
        return opnet_fused_forward(
            boxes, self.att_lstm.w_ih, self.att_lstm.w_hh, self.att_head.w,
            self.video_lstm.w_ih, self.video_lstm.w_hh, self.box_head.w, compute_dtype)

    def forward_layers(self, boxes: torch.Tensor):
        """`boxes (B, T, 15, F)` -> `(y (B, T, 4), logits (B, 15, T))`, layer
        by layer and differentiable."""
        batch, frames, objects, feat = boxes.shape
        att_h = self.att_lstm(boxes.reshape(batch, frames, objects * feat))
        logits = self.att_head(att_h)                                    # (B, T, 15)
        probs = torch.softmax(logits, dim=-1)
        selected = torch.einsum("btof,bto->btf", boxes, probs)
        y = self.box_head(self.video_lstm(selected))
        return y, logits.transpose(1, 2)
