"""The arithmetic of the benchmark's numbers: percentiles and the seeds
derived from `--seed`."""

import math

import numpy as np


def percentile(values, q):
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of `values` at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    if not 0 < q <= 100:
        raise ValueError(f"q must be in (0, 100], got {q}")
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100 * len(ordered)), 1) - 1]


def subseed(seed, tag):
    """A 63-bit seed for the stream `tag` of run seed `seed`: the streams of
    one seed are independent, and the same seed gives the same streams."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32, *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)
