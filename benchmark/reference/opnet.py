"""OPNet (Shamsian et al., "Learning Object Permanence from Video", ECCV
2020; `configs/opnet_model_config.json` of ofrikleinfeld/ObjectPermanence),
plain PyTorch, one frame at a time.

Per frame t: a who-to-attend LSTM over the flattened 15 x 6 scene, logits
over the 15 slots from its h, their softmax, the soft selection of one box
(the probability-weighted sum of the 15 rows), a video LSTM over that box
and a bias-free linear head to the normalised snitch box. No biases
anywhere. Weights are named as the benchmark makes them (`att_lstm.w_ih`,
...), each `(in, out)`.
"""

import torch

from benchmark.reference.common import lstm_cell, matmul


def forward(w, boxes, config, precision="fp32", generator=None, train=False):
    """`boxes (B, T, 15, 6)` -> normalised boxes `(B, T, 4)`. OPNet has no
    dropout, so `generator` and `train` change nothing."""
    batch, frames, objects, feat = boxes.shape
    xproj = matmul(boxes.reshape(batch, frames, objects * feat), w["att_lstm.w_ih"], precision)
    h1 = boxes.new_zeros(batch, w["att_lstm.w_hh"].shape[0])
    c1 = torch.zeros_like(h1)
    h2 = boxes.new_zeros(batch, w["video_lstm.w_hh"].shape[0])
    c2 = torch.zeros_like(h2)
    ys = []
    for t in range(frames):
        h1, c1 = lstm_cell(xproj[:, t] + matmul(h1, w["att_lstm.w_hh"], precision), c1)
        probs = torch.softmax(matmul(h1, w["att_head.w"], precision), dim=-1)
        selected = (boxes[:, t] * probs[..., None]).sum(dim=1)
        h2, c2 = lstm_cell(matmul(selected, w["video_lstm.w_ih"], precision)
                           + matmul(h2, w["video_lstm.w_hh"], precision), c2)
        ys.append(matmul(h2, w["box_head.w"], precision))
    return torch.stack(ys, dim=1)
