"""Learned reasoning models, the counterpart of
`objectpermanence_tpu/models/reasoning.py`: the OPNet family (`OPNet`,
`OPNetLSTMMLP`, `OPNetMoE`) and the baselines (`BaselineLSTM`,
`NonLinearLSTM`, `TransformerLSTM`).

Input: `boxes (B, T, 15, F)`, `[x1, y1, x2, y2, visible(, is_cone)]`
normalized by `[320, 240, 320, 240, 1(, 1)]`; F=6 for the OPNet family,
5 for the baselines.
Output of `forward_layers(boxes)`: `(y (B, T, 4), logits (B, 15, T))` for
the OPNet family (normalized snitch boxes and the who-to-attend logits),
`y` alone for the baselines, as the JAX `*_apply` functions return them.

Every layer is differentiable and every LSTM is `ops/lstm.py::LSTM`, so on
CUDA tensors the recurrences run on K2/K3 when a gradient is recorded and
on K4 otherwise. Only `OPNet.forward` is the fused inference kernel (K1).
Submodule and parameter names follow the JAX pytree (`att_lstm.w_ih`,
`video_lstm.0.w_hh`, `encoder.1.attn.w_in`...). `generator` in
`forward_layers` feeds dropout in train mode; only `TransformerLSTM` has
dropout.
"""

from typing import Dict

import torch
from torch import nn

from objectpermanence_tpu_torch import MAX_OBJECTS_IN_FRAME
from objectpermanence_tpu_torch.models.moe import MoEHead
from objectpermanence_tpu_torch.ops.attention import Encoder
from objectpermanence_tpu_torch.ops.linear import Linear
from objectpermanence_tpu_torch.ops.lstm import LSTM, StackedLSTM
from objectpermanence_tpu_torch.ops.opnet_fused import opnet_fused_forward

BB_OUT_DIM = 4


class _WhoToAttend(nn.Module):
    """The OPNet family's attention stage: a who-to-attend LSTM over the
    flattened scene, softmax over the 15 object slots, and the soft
    selection of one box per frame (`_who_to_attend`)."""

    def __init__(self, config: Dict[str, int], generator=None):
        super().__init__()
        feat = 6
        self.att_lstm = LSTM(feat * MAX_OBJECTS_IN_FRAME, config["object_to_track_hidden_dim"],
                             generator)
        self.att_head = Linear(config["object_to_track_hidden_dim"],
                               config["object_to_track_pred_dim"], generator)

    def who_to_attend(self, boxes: torch.Tensor):
        """-> (selected boxes `(B, T, F)`, logits `(B, T, 15)`)."""
        batch, frames, objects, feat = boxes.shape
        logits = self.att_head(self.att_lstm(boxes.reshape(batch, frames, objects * feat)))
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("btof,bto->btf", boxes, probs), logits


class OPNet(_WhoToAttend):
    """The who-to-attend stage, a video LSTM over the selected boxes and a
    linear box head. All layers bias-free.

    `forward` is the whole net as `ops/opnet_fused.py::opnet_fused_forward`:
    the fused kernel (K1) on CUDA tensors, its plain step loop on CPU
    tensors, with float32 or bfloat16 operands (`compute_dtype`); it is for
    inference and records no gradient. `forward_layers` is the same function
    layer by layer (`opnet_apply`), which the train and eval steps call."""

    def __init__(self, config: Dict[str, int], generator: torch.Generator = None):
        super().__init__(config, generator)
        self.video_lstm = LSTM(6, config["videos_hidden_dim"], generator)
        self.box_head = Linear(config["videos_hidden_dim"], BB_OUT_DIM, generator)

    def forward(self, boxes: torch.Tensor, compute_dtype: torch.dtype = torch.float32):
        return opnet_fused_forward(
            boxes, self.att_lstm.w_ih, self.att_lstm.w_hh, self.att_head.w,
            self.video_lstm.w_ih, self.video_lstm.w_hh, self.box_head.w, compute_dtype)

    def forward_layers(self, boxes: torch.Tensor, generator=None):
        selected, logits = self.who_to_attend(boxes)
        y = self.box_head(self.video_lstm(selected))
        return y, logits.transpose(1, 2)


class OPNetLSTMMLP(_WhoToAttend):
    """OPNet with the video LSTM replaced by a per-frame Linear + ReLU +
    Linear (`opnet_lstm_mlp_apply`)."""

    def __init__(self, config: Dict[str, int], generator: torch.Generator = None):
        super().__init__(config, generator)
        self.hidden = Linear(6, config["videos_hidden_dim"], generator)
        self.box_head = Linear(config["videos_hidden_dim"], BB_OUT_DIM, generator)

    def forward_layers(self, boxes: torch.Tensor, generator=None):
        selected, logits = self.who_to_attend(boxes)
        y = self.box_head(torch.relu(self.hidden(selected)))
        return y, logits.transpose(1, 2)



class OPNetMoE(_WhoToAttend):
    """OPNet with the linear box head replaced by the top-1 MoE head of
    `models/moe.py` (`opnet_moe_apply`); `num_experts` and `expert_hidden`
    default to 4 and 128, so OPNet's config serves. With `return_probs`,
    `forward_layers` also returns the router probs, from which the train
    step takes the balance term."""

    def __init__(self, config: Dict[str, int], generator: torch.Generator = None):
        super().__init__(config, generator)
        self.video_lstm = LSTM(6, config["videos_hidden_dim"], generator)
        self.box_head = MoEHead(config["videos_hidden_dim"], BB_OUT_DIM,
                                config.get("num_experts", 4), config.get("expert_hidden", 128),
                                generator)

    def forward_layers(self, boxes: torch.Tensor, generator=None, return_probs: bool = False):
        selected, logits = self.who_to_attend(boxes)
        y, probs = self.box_head(self.video_lstm(selected), return_probs=True)
        logits = logits.transpose(1, 2)
        return (y, logits, probs) if return_probs else (y, logits)



class BaselineLSTM(nn.Module):
    """One LSTM over the flattened 15 x 5 scene and a linear box head
    (`baseline_lstm_apply`)."""

    def __init__(self, config: Dict[str, int], generator: torch.Generator = None):
        super().__init__()
        hidden = config["videos_hidden_dim"]
        self.video_lstm = LSTM(MAX_OBJECTS_IN_FRAME * 5, hidden, generator)
        self.box_head = Linear(hidden, BB_OUT_DIM, generator)

    def forward_layers(self, boxes: torch.Tensor, generator=None):
        batch, frames, objects, feat = boxes.shape
        return self.box_head(self.video_lstm(boxes.reshape(batch, frames, objects * feat)))



class NonLinearLSTM(nn.Module):
    """Per-object Linear + ReLU features, a 2-layer LSTM over the 15
    objects' features and a linear box head (`non_linear_lstm_apply`)."""

    def __init__(self, config: Dict[str, int], generator: torch.Generator = None):
        super().__init__()
        box_feat, hidden = config["boxes_features_dim"], config["videos_hidden_dim"]
        self.box_proj = Linear(5, box_feat, generator)
        self.video_lstm = StackedLSTM(MAX_OBJECTS_IN_FRAME * box_feat, hidden, 2, generator)
        self.box_head = Linear(hidden, BB_OUT_DIM, generator)

    def forward_layers(self, boxes: torch.Tensor, generator=None):
        batch, frames = boxes.shape[:2]
        scene = torch.relu(self.box_proj(boxes)).reshape(batch, frames, -1)
        return self.box_head(self.video_lstm(scene))



class TransformerLSTM(nn.Module):
    """Per-object features, self-attention among objects, the snitch's slot
    (slot 0) taken out, a stacked LSTM and a linear box head
    (`transformer_lstm_apply`).

    By default the attention runs among the 15 objects of each frame, as the
    reference's comments describe. With `reference_compat` it runs as the
    reference's code does: each object slot is one sequence of all B*T
    tokens of the batch, so outputs depend on the batch and the attention
    costs (B*T)^2; reference-trained checkpoints reproduce only this way.
    The registry sets it from the model config's `reference_compat`."""

    def __init__(self, config: Dict[str, int], generator: torch.Generator = None,
                 reference_compat: bool = False):
        super().__init__()
        box_feat, hidden = config["boxes_features_dim"], config["lstm_hidden_dim"]
        self.box_proj = Linear(5, box_feat, generator)
        self.encoder = Encoder(config["num_attention_layers"], box_feat,
                               config["num_attention_heads"], generator=generator)
        self.video_lstm = StackedLSTM(box_feat, hidden, config["num_lstm_layers"], generator)
        self.box_head = Linear(hidden, BB_OUT_DIM, generator)
        self.reference_compat = reference_compat

    def forward_layers(self, boxes: torch.Tensor, generator=None):
        batch, frames, objects = boxes.shape[:3]
        feats = torch.relu(self.box_proj(boxes)).reshape(batch * frames, objects, -1)
        if self.reference_compat:
            snitch = self.encoder(feats.transpose(0, 1), generator)[0]
        else:
            snitch = self.encoder(feats, generator, slot=0)
        return self.box_head(self.video_lstm(snitch.reshape(batch, frames, -1)))

