"""K2/K4's launch plan on the CPU (`ops/lstm_scan.py::forward_launch_plan`,
the mirror of `csrc/lstm_scan.cu::make_fwd_plan`; a card test holds the two
equal).

The forward kernel is a cooperative grid of G video groups x S unit slices:
block (g, s) owns the videos of group g and the units of slice s for all T
steps, with the gate columns of its units in shared memory; a thread owns V
videos x one unit over 1 / KS of the contraction over k, staged in chunks of
KC rows of h. That is right only if

- every unit and every video is owned by exactly one block, and every block
  owns at least one of each;
- the grid fits the card at once (G x S <= SMs) and a block's shared memory
  fits the opt-in limit;
- the tile agrees with the group: V no larger than the group's videos, and
  a split contraction (KS > 1) only where one round of tasks holds the
  block's (video tile, unit) pairs;
- the KS parts of the chunks add every row of k exactly once.

Checked at the H100's 132 SMs and 232,448 bytes over the batches and widths
the port runs (the flagship's 256 and 512 at the training batch 16, the
eval batches 64 and 400, the served 512) and widths no split divides. The
plans at the flagship shapes are the ones `PERF.md` records. A torch
emulation of the kernel's order of k (part by part, chunk by chunk, parts
added in order) is held against the JAX package's forward kernel in
interpret mode at rtol 1e-4, atol 1e-6, as `tests/test_torch_lstm_scan.py`
holds the plain version: float32 sums in another order.
"""

import numpy as np
import pytest
import torch

import objectpermanence_tpu.ops.pallas_scan as ps
from objectpermanence_tpu_torch.ops.lstm_scan import (
    K_SPLITS, THREADS, TILES, forward_launch_plan, lstm_scan_forward_reference,
)
from torch_lane import one_torch_thread  # noqa: F401

SMS, SMEM = 132, 232448
WIDTHS = [16, 24, 132, 256, 260, 512, 1024]
BATCHES = [1, 13, 16, 37, 64, 400, 512]

# (hidden, batch): the plan recorded in PERF.md §6
FLAGSHIP = {
    (512, 16): dict(groups=4, slices=32, units=16, videos=4, tile=2, splits=8, stage=512),
    (256, 16): dict(groups=16, slices=8, units=32, videos=1, tile=1, splits=4, stage=256),
    (512, 64): dict(groups=4, slices=32, units=16, videos=16, tile=8, splits=8, stage=512),
    (256, 64): dict(groups=16, slices=8, units=32, videos=4, tile=4, splits=8, stage=256),
    (512, 400): dict(groups=3, slices=40, units=13, videos=134, tile=16, splits=2, stage=64),
    (256, 400): dict(groups=13, slices=8, units=32, videos=31, tile=16, splits=4, stage=256),
}


def _padded(videos):
    return -(-videos // 4) * 4


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("hidden", WIDTHS)
def test_forward_plan_owns_every_unit_and_video_once_and_fits(hidden, batch):
    plan = forward_launch_plan(hidden, batch, SMS, SMEM)
    groups, slices, units, videos = (plan[k] for k in ("groups", "slices", "units", "videos"))
    # one grid holds these batches at the widths the port runs; at 1024 the
    # largest take passes, each over the next ceil(B / passes) videos
    passes = plan["passes"]
    assert passes == 1 or hidden > 512
    pass_videos = -(-batch // passes)
    # slices of U units and groups of Bg videos of a pass cover each exactly
    # once, none empty
    assert slices == -(-hidden // units) and groups == -(-pass_videos // videos)
    owner_unit = np.arange(hidden) // units
    b = np.arange(batch)
    owner_video = set(zip(b // pass_videos, b % pass_videos // videos))
    assert set(owner_unit) == set(range(slices))
    assert owner_video == {(p, g) for p in range(passes) for g in range(groups)
                           if p * pass_videos + g * videos < batch}
    assert plan["blocks"] == groups * slices <= SMS
    assert plan["lanes"] == 0
    # shared memory: the columns, the stage area (the chunks of h, then each
    # thread's V partial gates), and c, h and xproj of the block's pairs
    padded = _padded(videos)
    chunk, tile, splits = plan["stage"], plan["tile"], plan["splits"]
    per_round = max(32, min(THREADS // splits, -(-(units * -(-videos // tile)) // 32) * 32))
    stage = max((1 if chunk >= hidden else 2) * chunk * padded, 4 * tile * splits * per_round)
    assert plan["smem"] <= SMEM
    assert plan["smem"] >= 16 * hidden * units + 4 * (stage + padded * (6 * units + 1))
    assert plan["scratch"] == 4 * 2 * groups * hidden * padded + 4 * groups
    # the tile and the parts of k agree with the group
    assert tile in TILES and (tile == 1 or tile <= videos)
    assert splits in K_SPLITS
    if splits > 1:
        assert units * -(-videos // tile) * splits <= THREADS
    assert chunk % 8 == 0 and 8 <= chunk <= -(-hidden // 8) * 8


@pytest.mark.parametrize("shape", sorted(FLAGSHIP))
def test_forward_plan_at_the_flagship_shapes_is_the_recorded_one(shape):
    plan = forward_launch_plan(*shape, SMS, SMEM)
    assert {k: plan[k] for k in FLAGSHIP[shape]} == FLAGSHIP[shape]


@pytest.mark.parametrize("hidden", [2048, 4096])
def test_forward_plan_raises_when_no_grid_fits(hidden):
    with pytest.raises(RuntimeError, match="no grid"):
        forward_launch_plan(hidden, 16, SMS, SMEM)


def test_forward_plan_takes_passes_when_a_grid_cannot_hold_the_batch():
    """A batch whose c and h no grid's shared memory holds runs in passes of
    ceil(B / P) videos, each a launch of the same grid."""
    plan = forward_launch_plan(1024, 4096, SMS, SMEM)
    assert plan["passes"] > 1 and plan["passes"] * plan["videos"] * plan["groups"] >= 4096
    assert plan["smem"] <= SMEM


def _k_parts(hidden, plan):
    """The rows of k each of the KS parts adds, in the kernel's order: chunk
    by chunk, rows [ks * part, (ks + 1) * part) of each chunk."""
    chunk, splits = plan["stage"], plan["splits"]
    parts = [[] for _ in range(splits)]
    for k0 in range(0, hidden, chunk):
        rows = min(chunk, hidden - k0)
        part = -(-rows // splits)
        for ks in range(splits):
            lo = min(rows, ks * part)
            parts[ks].extend(range(k0 + lo, k0 + min(rows, lo + part)))
    return [torch.tensor(p, dtype=torch.long) for p in parts]


def _emulate(xproj, w_hh, plan):
    """hs, cs of the kernel's arithmetic: each part's rows of k, the parts
    added in order, then the cell."""
    parts = _k_parts(w_hh.shape[0], plan)
    h = xproj.new_zeros(xproj.shape[1], w_hh.shape[0])
    c = torch.zeros_like(h)
    hs, cs = [], []
    for t in range(xproj.shape[0]):
        acc = torch.zeros_like(xproj[t])
        if t > 0:
            for idx in parts:
                acc = acc + h[:, idx] @ w_hh[idx]
        i, f, g, o = (xproj[t] + acc).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


# small cards and shared memories, so that the plans take chunks of k, split
# contractions and register tiles of several videos
@pytest.mark.parametrize("hidden,batch,sms,smem", [
    (128, 8, 16, 30000), (96, 30, 12, 60000), (200, 40, 8, 120000), (24, 5, 8, SMEM),
    (40, 13, 8, SMEM)])
def test_kernel_order_of_k_matches_the_jax_forward(hidden, batch, sms, smem):
    plan = forward_launch_plan(hidden, batch, sms, smem)
    parts = _k_parts(hidden, plan)
    assert sorted(torch.cat(parts).tolist()) == list(range(hidden))  # each row once
    rng = np.random.RandomState(hidden + batch)
    k = 1.0 / np.sqrt(hidden)
    w_hh = rng.uniform(-k, k, (hidden, 4 * hidden)).astype(np.float32)
    xproj = rng.randn(6, batch, 4 * hidden).astype(np.float32)
    # one batch tile: the kernel's grid takes B // block_b tiles
    want_hs, want_cs = ps._lstm_fwd_pallas(w_hh, xproj, block_b=batch, interpret=True)
    hs, cs = _emulate(torch.from_numpy(xproj), torch.from_numpy(w_hh), plan)
    plain_hs, _ = lstm_scan_forward_reference(torch.from_numpy(xproj), torch.from_numpy(w_hh))
    for got, want in ((hs, want_hs), (cs, want_cs), (plain_hs, want_hs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
