"""The port's NMS (`ops/nms.py`, plain torch) against the JAX package's:
keep masks and orders must be identical, ties included.

Inputs come from numpy seeds: clusters of overlapping boxes (chains of
suppression), exact duplicate scores, NEG_INF padding and several
classes. JAX's functions take one row; the port's take a batch of rows,
so each test also checks that a batch gives each row's own answer.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from objectpermanence_tpu.ops import nms as jax_nms
from objectpermanence_tpu.ops.boxes import pairwise_iou_xyxy as jax_pairwise_iou
from objectpermanence_tpu_torch.ops import nms
from objectpermanence_tpu_torch.ops.boxes import pairwise_iou_xyxy
from torch_lane import one_torch_thread  # noqa: F401


def _boxes(rng, n, clusters=4):
    """n boxes around a few centres, so many overlap above 0.5 and 0.7."""
    centres = rng.uniform(20, 200, (clusters, 2))
    pick = centres[rng.randint(0, clusters, n)] + rng.normal(0, 4, (n, 2))
    size = rng.uniform(10, 40, (n, 2))
    return np.concatenate([pick - size / 2, pick + size / 2], 1).astype(np.float32)


def _scores(rng, n, pad=0, ties=0):
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:  # exact duplicates of a few scores
        scores[rng.choice(n, ties, replace=False)] = scores[0]
    if pad:
        scores[rng.choice(n, pad, replace=False)] = nms.NEG_INF
    return scores


def _chain(n=12, step=3.0):
    """Boxes shifted one after another: each overlaps its neighbour above
    0.7, so greedy NMS keeps every other one (a chain n deep)."""
    x = np.arange(n, dtype=np.float32) * step
    boxes = np.stack([x, np.zeros(n), x + 20, np.full(n, 20)], 1).astype(np.float32)
    return boxes, np.linspace(1, 0.5, n).astype(np.float32)


def test_constants_match():
    assert nms.NEG_INF == jax_nms.NEG_INF


def test_pairwise_iou_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    a[3] = [5, 5, 5, 9]  # zero area
    b[4] = a[3]          # zero union
    want = np.asarray(jax_pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    got = pairwise_iou_xyxy(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    batched = pairwise_iou_xyxy(torch.from_numpy(np.stack([a, a])), torch.from_numpy(np.stack([b, b])))
    np.testing.assert_array_equal(batched[1].numpy(), got)


@pytest.mark.parametrize("threshold", [0.5, 0.7])
@pytest.mark.parametrize("seed,n,pad,ties", [(0, 64, 0, 0), (1, 100, 17, 0), (2, 57, 5, 9),
                                             (3, 200, 40, 20)])
def test_nms_mask_identical(seed, n, pad, ties, threshold):
    rng = np.random.RandomState(seed)
    rows = [(_boxes(rng, n), _scores(rng, n, pad, ties)) for _ in range(3)]
    want = [np.asarray(jax_nms.nms_mask(jnp.asarray(b), jnp.asarray(s), threshold))
            for b, s in rows]
    got = nms.nms_mask(torch.from_numpy(np.stack([b for b, _ in rows])),
                       torch.from_numpy(np.stack([s for _, s in rows])), threshold).numpy()
    for row, (w, (b, s)) in enumerate(zip(want, rows)):
        np.testing.assert_array_equal(got[row], w)
        one = nms.nms_mask(torch.from_numpy(b), torch.from_numpy(s), threshold).numpy()
        np.testing.assert_array_equal(one, w)
    assert any(0 < w.sum() < n - pad for w in want)  # something was suppressed


def test_nms_chain_and_equal_scores():
    boxes, scores = _chain()
    for s in (scores, np.full_like(scores, 0.5)):  # all tied: index order decides
        want = np.asarray(jax_nms.nms_mask(jnp.asarray(boxes), jnp.asarray(s), 0.7))
        got = nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(s), 0.7).numpy()
        np.testing.assert_array_equal(got, want)
        assert want.tolist() == [i % 2 == 0 for i in range(len(boxes))]


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 23])
def test_nms_mask_rows_settle_each_at_its_own_depth(depth):
    """A batch whose rows need different numbers of rounds: a chain `depth`
    deep, padded to 90 boxes, beside clustered rows with padding and ties.
    Each row is JAX's mask for it alone, the chain keeps every other box,
    and on the CPU no kernel launches (`nms_mask.launches`)."""
    n = 90
    chain, chain_scores = _chain(depth)
    boxes = np.zeros((n, 4), np.float32)
    boxes[:depth] = chain
    scores = np.full(n, nms.NEG_INF, np.float32)
    scores[:depth] = chain_scores
    rng = np.random.RandomState(depth)
    rows = [(boxes, scores)] + [(_boxes(rng, n), _scores(rng, n, pad=11, ties=6))
                                for _ in range(3)]
    launches = nms.nms_mask.launches
    got = nms.nms_mask(torch.from_numpy(np.stack([b for b, _ in rows])),
                       torch.from_numpy(np.stack([s for _, s in rows])), 0.7).numpy()
    assert nms.nms_mask.launches == launches
    for row, (b, s) in enumerate(rows):
        want = np.asarray(jax_nms.nms_mask(jnp.asarray(b), jnp.asarray(s), 0.7))
        np.testing.assert_array_equal(got[row], want)
    assert got[0].tolist() == [i < depth and i % 2 == 0 for i in range(n)]


def test_nms_threshold_is_strict():
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 5]], np.float32)  # IoU exactly 0.5
    scores = np.array([0.9, 0.8], np.float32)
    for threshold, kept in ((0.5, [True, True]), (0.49, [True, False])):
        want = np.asarray(jax_nms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), threshold))
        got = nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), threshold)
        assert got.tolist() == want.tolist() == kept


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_class_nms_identical(seed):
    rng = np.random.RandomState(seed)
    n = 150
    rows = []
    for _ in range(2):
        boxes = _boxes(rng, n, clusters=3)
        scores = _scores(rng, n, pad=11, ties=6)
        labels = rng.randint(1, 5, n).astype(np.int32)
        rows.append((boxes, scores, labels))
    want = [np.asarray(jax_nms.batched_class_nms(jnp.asarray(b), jnp.asarray(s),
                                                 jnp.asarray(lab), 0.5))
            for b, s, lab in rows]
    got = nms.batched_class_nms(*(torch.from_numpy(np.stack(x)) for x in zip(*rows)),
                                0.5).numpy()
    for row, w in enumerate(want):
        np.testing.assert_array_equal(got[row], w)
    # class-blind NMS would keep fewer: the offsets keep classes apart
    blind = nms.nms_mask(torch.from_numpy(rows[0][0]), torch.from_numpy(rows[0][1]), 0.5)
    assert int(blind.sum()) < int(want[0].sum())


@pytest.mark.parametrize("k", [1, 10, 64, 500])
def test_top_k_by_score_identical(k):
    rng = np.random.RandomState(k)
    n = 64
    boxes = _boxes(rng, n)
    scores = _scores(rng, n, pad=9, ties=12)
    labels = rng.randint(0, 7, n).astype(np.int32)
    want = jax_nms.top_k_by_score(jnp.asarray(boxes), jnp.asarray(scores), k, jnp.asarray(labels))
    got = nms.top_k_by_score(torch.from_numpy(boxes), torch.from_numpy(scores), k,
                             torch.from_numpy(labels))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    batched = nms.top_k_by_score(torch.from_numpy(np.stack([boxes, boxes])),
                                 torch.from_numpy(np.stack([scores, scores])), k,
                                 torch.from_numpy(np.stack([labels, labels])))
    for g, w in zip(batched, want):
        np.testing.assert_array_equal(g[1].numpy(), np.asarray(w))


def test_top_k_ties_lower_index_first():
    scores = torch.tensor([1.0, 2.0, 2.0, 0.0, 2.0])
    _, top, idx = nms.top_k_by_score(torch.zeros(5, 4), scores, 3, torch.arange(5))
    assert idx.tolist() == [1, 2, 4] and top.tolist() == [2.0, 2.0, 2.0]
