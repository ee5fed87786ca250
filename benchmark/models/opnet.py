"""OPNet's adapter: the port's `opnet` with the benchmark's weights."""

import math

from benchmark.models import UNIFORM

PORT_NAME = "opnet"
FEATURES = 6
OBJECTS = 15


def leaves(config):
    h1, h2 = config["object_to_track_hidden_dim"], config["videos_hidden_dim"]
    k1, k2 = 1 / math.sqrt(h1), 1 / math.sqrt(h2)
    return [("att_lstm.w_ih", (OBJECTS * FEATURES, 4 * h1), (UNIFORM, k1)),
            ("att_lstm.w_hh", (h1, 4 * h1), (UNIFORM, k1)),
            ("att_head.w", (h1, config["object_to_track_pred_dim"]), (UNIFORM, k1)),
            ("video_lstm.w_ih", (FEATURES, 4 * h2), (UNIFORM, k2)),
            ("video_lstm.w_hh", (h2, 4 * h2), (UNIFORM, k2)),
            ("box_head.w", (h2, 4), (UNIFORM, k2))]


def flops_per_frame(config):
    """Two operations for each weight: every product of the forward is a
    frame's vector times one weight matrix (2 x 1,421,056 at the published
    widths, as `bounds.opnet_fused` counts K1)."""
    return 2 * sum(shape[0] * shape[1] for _, shape, _ in leaves(config))


def lstm_widths(config):
    return [config["object_to_track_hidden_dim"], config["videos_hidden_dim"]]
