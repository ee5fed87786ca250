"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run
(`harness.run_cell`) at a small size on the CPU, where the port runs its
plain paths: first sound, then with one fault planted in the port, as
each cell can have it."""

import pytest
import torch

from benchmark import harness

from conftest import TINY_CONFIGS, TINY_MIXES

SERVE = ["opnet.serve_b512", "transformer_lstm.serve_b512"]
TRAIN = ["transformer_lstm.train_b16"]


def _run(manifest, cell, seed=2**33 + 7):
    config, kind = cell.split(".")[0], "serve" if "serve" in cell else "train"
    result, _, compared = harness.run_cell(
        manifest, cell, seed, 0.3, False, torch.device("cpu"), 0.0,
        config=TINY_CONFIGS[config], mix=TINY_MIXES[kind], log=lambda text: None)
    return result, compared


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_a_sound_run_is_correct(manifest, cell):
    result, compared = _run(manifest, cell)
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {name for name, _, _ in compared}


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_answer_is_caught(manifest, cell, monkeypatch):
    from objectpermanence_tpu_torch.infer import reasoning

    plain = reasoning.denormalize_boxes

    def altered(boxes, dtype):
        out = plain(boxes, dtype).clone()
        out[0] += 9  # the first video of every batch, 9 px off
        return out

    monkeypatch.setattr(reasoning, "denormalize_boxes", altered)
    result, compared = _run(manifest, cell)
    assert not result["correct"], compared


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_caught(manifest, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result, compared = _run(manifest, cell)
    assert not result["correct"], compared


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out_is_caught(manifest, cell, monkeypatch):
    from objectpermanence_tpu_torch.train import loop

    plain = loop.total_loss

    def half(output, labels, mask, no_labels, sample_weight=None):
        keep = output.shape[0] // 2
        return plain(output[:keep], labels[:keep], mask[:keep], no_labels)

    monkeypatch.setattr(loop, "total_loss", half)
    result, compared = _run(manifest, cell)
    assert not result["correct"], compared
