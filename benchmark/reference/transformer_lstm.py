"""The transformer_lstm baseline of ofrikleinfeld/ObjectPermanence
(`configs/transformer_lstm_model_config.json`), plain PyTorch.

Per frame: each of the 15 object rows `[x1, y1, x2, y2, visible]` through a
linear map to 256 and a ReLU; two post-LN encoder layers, as
`torch.nn.TransformerEncoderLayer` builds them by default (2 heads, feed-
forward 2048 with ReLU, dropout 0.1 on the attention output, inside the
feed-forward block and on its output, LayerNorm eps 1e-5), with the
attention among the frame's 15 objects; the snitch's slot (slot 0) taken
out; a 2-layer LSTM of 512 over the frames; a bias-free linear head to the
normalised box.

Dropout runs in train mode only, each mask drawn as
`torch.rand(shape, generator) >= 0.1` in the order the layers apply it
(layer by layer: attention output, feed-forward inside, feed-forward
output) over all B*T*15 tokens, the draw the port makes from the same seed.
"""

import math

import torch
import torch.nn.functional as F

from benchmark.reference.common import lstm, matmul

DROPOUT = 0.1
LN_EPS = 1e-5


def _dropout(x, generator):
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= DROPOUT
    return torch.where(keep, x / (1.0 - DROPOUT), torch.zeros((), dtype=x.dtype, device=x.device))


def _linear(x, w, b, precision):
    return matmul(x, w, precision) + b


def _encoder_layer(w, p, x, heads, precision, drop):
    """Post-LN layer `p` over tokens `x (N, 15, D)`."""
    n, length, dim = x.shape
    head_dim = dim // heads
    qkv = _linear(x, w[p + "attn.w_in"].reshape(dim, 3 * dim),
                  w[p + "attn.b_in"].reshape(3 * dim), precision)
    q, k, v = (t.reshape(n, length, heads, head_dim).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    probs = torch.softmax(matmul(q, k.transpose(-1, -2), precision) / math.sqrt(head_dim), -1)
    ctx = matmul(probs, v, precision).transpose(1, 2).reshape(n, length, dim)
    attn = _linear(ctx, w[p + "attn.out.w"], w[p + "attn.out.b"], precision)
    x = F.layer_norm(x + drop(attn), (dim,), w[p + "norm1.scale"], w[p + "norm1.bias"], LN_EPS)
    ff = _linear(drop(torch.relu(_linear(x, w[p + "ff1.w"], w[p + "ff1.b"], precision))),
                 w[p + "ff2.w"], w[p + "ff2.b"], precision)
    return F.layer_norm(x + drop(ff), (dim,), w[p + "norm2.scale"], w[p + "norm2.bias"], LN_EPS)


def forward(w, boxes, config, precision="fp32", generator=None, train=False):
    """`boxes (B, T, 15, 5)` -> normalised boxes `(B, T, 4)`; dropout from
    `generator` when `train`."""
    heads = config["num_attention_heads"]
    layers = config["num_attention_layers"]
    lstm_layers = config["num_lstm_layers"]
    batch, frames, objects, _ = boxes.shape

    def drop(t):
        return _dropout(t, generator) if train else t

    x = torch.relu(matmul(boxes, w["box_proj.w"], precision)).reshape(batch * frames, objects, -1)
    for i in range(layers):
        x = _encoder_layer(w, f"encoder.{i}.", x, heads, precision, drop)
    seq = x[:, 0].reshape(batch, frames, -1)
    for i in range(lstm_layers):
        seq = lstm(seq, w[f"video_lstm.{i}.w_ih"], w[f"video_lstm.{i}.w_hh"], precision)
    return matmul(seq, w["box_head.w"], precision)
