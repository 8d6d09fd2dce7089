"""Operation and byte counts against counts taken at small shapes, and the
trace reduction on a hand-made trace."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import flops
from benchmark.reference import model as M
from benchmark.tests import tiny
from benchmark.trace import STRETCH, summarize
from benchmark.weights import dit_spec, make

CFG = {"dim": 64, "depth": 2, "heads": 2, "dim_head": 32, "ff_mult": 2, "mel_dim": 100, "text_num_embeds": 256,
       "text_dim": 64, "conv_layers": 1, "conv_mult": 2}


def test_dit_token_flops_counts_every_product(monkeypatch):
    """The reference's DiT forward over n frames, its products and
    convolutions counted as they run: those over the frames sum to n times
    `dit_token_flops` (the time conditioning, one row, is left out)."""
    n, counted = 37, []
    real_linear, real_conv = F.linear, F.conv1d

    def linear(x, w, b=None):
        rows = x.numel() // x.shape[-1]
        if rows == n:
            counted.append(2 * rows * w.shape[0] * w.shape[1])
        return real_linear(x, w, b)

    def conv1d(x, w, b=None, padding=0, groups=1):
        counted.append(2 * w.shape[0] * w.shape[1] * w.shape[2] * x.shape[-1])
        return real_conv(x, w, b, padding=padding, groups=groups)

    P = make(dit_spec(CFG), 1, "cpu")
    x = torch.randn(1, n, 100)
    te = torch.randn(1, n, 64)
    t_emb = torch.randn(1, 64)
    monkeypatch.setattr(F, "linear", linear)
    monkeypatch.setattr(F, "conv1d", conv1d)
    M.dit(P, CFG, x, x, te, t_emb, torch.tensor([False]))
    assert sum(counted) == n * flops.dit_token_flops(CFG)


def test_attention_and_kernel_counts_by_hand():
    assert flops.attention_pairs(CFG) == 4 * 2 * 32 * 2
    assert flops.k1_call(CFG, [3, 5], 8) == (4 * 2 * 32 * (9 + 25), 2 * 4 * 2 * 32 * 8)
    assert flops.k1_call(CFG, [8, 8], 8, lse=True)[1] == 2 * 4 * 2 * 32 * 16 + 4 * 2 * 8 * 2
    assert flops.k2_call(CFG, 3, 8) == (10 * 3 * 2 * 64 * 32, 2 * 8 * 3 * 2 * 8 * 32 + 4 * 3 * 2 * 8)
    assert flops.least_seconds(989e12, 0) == 1.0 and flops.least_seconds(0, 3.35e12) == 1.0
    assert flops.train_step_flops({"dit": CFG}, 2, 10) == 3 * (20 * (flops.dit_token_flops(CFG) + flops.text_token_flops(
        CFG)) + 200 * flops.attention_pairs(CFG))


def test_trace_reduction():
    ev = [{"name": STRETCH, "cat": "user_annotation", "ts": 100, "dur": 100},
          {"name": "k_a", "cat": "kernel", "ts": 90, "dur": 20},
          {"name": "k_b", "cat": "kernel", "ts": 105, "dur": 10},
          {"name": "k_a", "cat": "kernel", "ts": 150, "dur": 10},
          {"name": "copy", "cat": "gpu_memcpy", "ts": 190, "dur": 30},
          {"name": "aten::mm", "cat": "cpu_op", "ts": 115, "dur": 40},
          {"name": "aten::add", "cat": "cpu_op", "ts": 120, "dur": 5},
          {"name": "outside", "cat": "kernel", "ts": 300, "dur": 10}]
    s = summarize(ev)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((15 + 10 + 10) * 1e-6)
    assert s.kernels["k_a"] == [pytest.approx(20e-6), 2] and "outside" not in s.kernels
    assert s.kernel_seconds("k_") == (pytest.approx(30e-6), 3)
    assert s.idle_by_host["aten::mm"] == pytest.approx(35e-6)
    assert s.idle_by_host["no host activity traced"] == pytest.approx(30e-6)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "k_a" and len(b["idle_gaps"]) == 2
    assert np.isclose(sum(x for _, x in b["idle_gaps"]), 65e-6)


def test_mfu_reads_the_traced_cycle():
    """The traced steps' operations over the traced stretch's seconds; no
    trace, nothing to read."""
    from benchmark.metrics import mfu_train
    from benchmark.trace import Summary

    config = {"dit": CFG}
    steps = [{"b": 2, "n": 10, "traced": True}, {"b": 4, "n": 5, "traced": True}, {"b": 1, "n": 9, "traced": False}]
    obs = {"kind": "train", "config": config, "steps": steps, "trace": Summary(window_s=2.0, busy_s=1.0)}
    work = flops.train_step_flops(config, 2, 10) + flops.train_step_flops(config, 4, 5)
    assert mfu_train.read(obs) == pytest.approx(100.0 * work / (2.0 * flops.PEAK_BF16_FLOPS))
    assert mfu_train.read(dict(obs, trace=None)) is None
