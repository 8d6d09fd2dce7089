"""Inputs drawn from the seed, for every traffic mix.

Sizes come from fixed sets (quantiles of the mix's distributions) that
each seed puts in another order, so every seed asks for the same work and
runs differ by their content and their order, not by how much there is to
do.
"""

from __future__ import annotations

import statistics

import numpy as np

from benchmark.weights import sub_seed


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *tags))


def lognormal_set(n: int, median: float, sigma: float, lo: float, hi: float) -> np.ndarray:
    """n values at the quantiles (i + 1/2) / n of a log-normal, clipped."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(median * np.exp(sigma * z), lo, hi)


def dynamic_batches(lengths: np.ndarray, max_frames: int, max_samples: int) -> list[np.ndarray]:
    """Indices of `lengths`, sorted by length and cut so that the longest
    item times the batch size stays within `max_frames`, and no batch holds
    more than `max_samples` (F5-TTS's frame-budget sampler; the port's
    `Stream.dynamic_batch` rule with the sample cap)."""
    order = np.argsort(lengths, kind="stable")
    batches, cur = [], []
    for i in order:
        if cur and ((len(cur) + 1) * lengths[i] > max_frames or len(cur) >= max_samples):
            batches.append(np.array(cur))
            cur = []
        cur.append(i)
    if cur:
        batches.append(np.array(cur))
    return batches
