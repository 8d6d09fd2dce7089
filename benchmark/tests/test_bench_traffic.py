"""Traffic from the seed: the same twice, another order of the same sizes
for another seed; the frame-budget cut; the start after warm-up."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from benchmark import inputs as I
from benchmark import run as R
from benchmark.traffic import train_steps

CELL = "f5tts_v1_base.train_38k"


def fake_run(cell: str, seed: int, seconds: float = 50.0):
    c = R.load(R.HERE, "workloads", cell)
    return types.SimpleNamespace(seed=seed, seconds=seconds, config=R.load(R.HERE, "configs", c["config"]),
                                 mix=R.load(R.HERE, "traffic", c["traffic"]), device=torch.device("cpu"))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 123])
def test_same_sizes_for_every_seed(seed):
    """Every seed trains the same batches in another order; a step's
    content and dropout generator are the seed's and the step's."""
    a, b = train_steps.Feed(fake_run(CELL, seed)), train_steps.Feed(fake_run(CELL, seed + 1))
    n = len(a.batches)
    assert sorted(a.lens(k).tolist() for k in range(n)) == sorted(b.lens(k).tolist() for k in range(n))
    assert a.lens(0).max() == b.lens(0).max() == max(a.lengths)
    x, again, other = a.batch(1), a.batch(1), b.batch(1)
    assert torch.equal(x["mel"], again["mel"]) and torch.equal(x["draws"]["x0"], again["draws"]["x0"])
    assert not torch.equal(x["draws"]["audio_drop"], other["draws"]["audio_drop"])
    draws = [torch.rand(4, generator=g) for g in (a.generator(1), a.generator(1), a.generator(2), b.generator(1))]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], draws[3])


def test_the_steps_start_after_warm_up():
    run = fake_run(CELL, 1)
    assert train_steps.start_count(run) == run.config["training"]["warmup_steps"] == 20000
    run.mix = dict(run.mix, after_warmup=False)
    assert train_steps.start_count(run) == 0


def test_training_feed():
    feeds = [train_steps.Feed(fake_run(CELL, s)) for s in (3, 4)]
    for f in feeds:
        mix = f.run.mix
        for idx in f.batches:
            lens = f.lengths[idx]
            assert len(lens) * lens.max() <= mix["max_frames"] and len(lens) <= mix["max_samples"]
        first = f.lens(0)
        assert first.max() == max(f.lengths[i].max() for i in f.batches)
    n = len(feeds[0].batches)
    for f in feeds:
        assert sorted(int(f.lens(k).sum()) for k in range(n)) == sorted(int(f.lengths[i].sum()) for i in f.batches)
    assert [feeds[0].lens(k).tolist() for k in range(n)] != [feeds[1].lens(k).tolist() for k in range(n)]


def test_dynamic_batches_cut():
    lengths = np.array([5, 1, 9, 3, 7, 2, 8])
    batches = I.dynamic_batches(lengths, max_frames=16, max_samples=3)
    assert [lengths[b].tolist() for b in batches] == [[1, 2, 3], [5, 7], [8], [9]]
