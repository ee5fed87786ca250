"""transformer_lstm's adapter: the port's `transformer_lstm` with the
benchmark's weights, initialised as torch's layers initialise themselves
(linear U(+-1/sqrt(in)), the fused attention in-projection xavier-uniform
with zero biases, LayerNorm ones and zeros, LSTMs U(+-1/sqrt(H)))."""

import math

from benchmark.models import ONES, UNIFORM, ZEROS

PORT_NAME = "transformer_lstm"
FEATURES = 5
OBJECTS = 15


def leaves(config):
    dim, heads, ff = config["boxes_features_dim"], config["num_attention_heads"], config["ff_dim"]
    hidden = config["lstm_hidden_dim"]
    out = [("box_proj.w", (FEATURES, dim), (UNIFORM, 1 / math.sqrt(FEATURES)))]
    for i in range(config["num_attention_layers"]):
        p = f"encoder.{i}."
        out += [(p + "attn.w_in", (dim, 3, heads, dim // heads),
                 (UNIFORM, math.sqrt(6 / (4 * dim)))),
                (p + "attn.b_in", (3, heads, dim // heads), (ZEROS,)),
                (p + "attn.out.w", (dim, dim), (UNIFORM, 1 / math.sqrt(dim))),
                (p + "attn.out.b", (dim,), (ZEROS,)),
                (p + "ff1.w", (dim, ff), (UNIFORM, 1 / math.sqrt(dim))),
                (p + "ff1.b", (ff,), (UNIFORM, 1 / math.sqrt(dim))),
                (p + "ff2.w", (ff, dim), (UNIFORM, 1 / math.sqrt(ff))),
                (p + "ff2.b", (dim,), (UNIFORM, 1 / math.sqrt(ff))),
                (p + "norm1.scale", (dim,), (ONES,)), (p + "norm1.bias", (dim,), (ZEROS,)),
                (p + "norm2.scale", (dim,), (ONES,)), (p + "norm2.bias", (dim,), (ZEROS,))]
    k = 1 / math.sqrt(hidden)
    for i in range(config["num_lstm_layers"]):
        out += [(f"video_lstm.{i}.w_ih", (dim if i == 0 else hidden, 4 * hidden), (UNIFORM, k)),
                (f"video_lstm.{i}.w_hh", (hidden, 4 * hidden), (UNIFORM, k))]
    return out + [("box_head.w", (hidden, 4), (UNIFORM, k))]


def flops_per_frame(config):
    """Two operations a multiply-add, for what the output needs: the box
    projection of the 15 objects; every encoder layer but the last over all
    15 tokens (in-projection, scores and mixing per head, out-projection,
    feed-forward); the last layer's keys and values over the 15 tokens, and
    its query, scores, mixing, out-projection and feed-forward for slot 0
    alone, the one row the LSTMs read; both LSTMs; the head. LayerNorm,
    softmax and the gates' elementwise work are not counted."""
    dim, ff, hidden = config["boxes_features_dim"], config["ff_dim"], config["lstm_hidden_dim"]
    n = OBJECTS

    def layer(queries):
        projections = 2 * n * dim * 2 * dim + 2 * queries * dim * dim   # keys, values; queries
        attention = 2 * 2 * queries * n * dim                          # scores and mixing
        rest = 2 * queries * (dim * dim + 2 * dim * ff)                 # out-projection, ff
        return projections + attention + rest

    layers = config["num_attention_layers"]
    lstms = sum(2 * 4 * hidden * (d + hidden) for d in [dim] + [hidden] * (config["num_lstm_layers"] - 1))
    return 2 * n * FEATURES * dim + (layers - 1) * layer(n) + layer(1) + lstms + 2 * hidden * 4


def lstm_widths(config):
    return [config["lstm_hidden_dim"]] * config["num_lstm_layers"]
