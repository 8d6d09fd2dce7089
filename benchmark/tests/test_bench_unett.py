"""The E2 TTS Base cell (`e2tts_base.train_38k`) on the CPU at a tiny size,
through the harness with its look for a card skipped: the port in float32
agrees with the benchmark's reference copy (benchmark/reference/unett.py)
to rounding, dropout included; a broken timed path and the fp8 control
read apart from it; every reader of the DiT cell returns None on the
UNetT's observation and the UNetT's readers on the DiT's; and the counts
of benchmark/flops_unett.py against hand-computed shapes."""

from __future__ import annotations

import importlib
import json
import math
import pkgutil

import pytest
import torch
import torch.nn.functional as F

from benchmark import flops, flops_unett as FU
from benchmark import run as R
from benchmark.reference import unett as U
from benchmark.tests import tiny
from benchmark.trace import STRETCH, Summary
from benchmark.traffic import unett_steps
from benchmark.weights import make

CELL = "e2tts_base.train_38k"
LIMITS = {"loss_rel_gap": 1e-5, "grad_norm_gap": 1e-4, "update_norm_gap": 1e-3, "ema_change_gap": 1e-3}
TIGHT = dict(LIMITS, **{"warm_" + k: v for k, v in LIMITS.items()})
CFG = {"dim": 64, "depth": 4, "heads": 4, "dim_head": 16, "ff_mult": 4, "mel_dim": 100, "text_num_embeds": 256,
       "text_dim": 100, "text_mask_padding": False, "pe_attn_head": 1, "dropout": 0.1, "compute_dtype": "float32"}


def result(root, capsys, **options) -> dict:
    rc = R.main(["--workload", CELL, "--seed", str(2**31 + 29), "--seconds", "1"], require_cuda=False, root=root,
                **options)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def tight_root(tmp_path, dtype: str = "float32"):
    root = tiny.tiny_root(tmp_path, dtype)
    c = json.loads((root / "workloads" / f"{CELL}.json").read_text())
    tiny.write_cell(root, CELL, **dict(c, limits=TIGHT))
    return root


def test_float32_port_agrees_with_the_reference_copy(tmp_path, capsys):
    out = result(tight_root(tmp_path), capsys)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(TIGHT) and out["attempted"] >= 1


@pytest.mark.parametrize("fault,fails", [("unchanged", "update_norm_gap"), ("half_batch", "update_norm_gap"),
                                         ("ema_unchanged", "ema_change_gap")])
def test_a_broken_timed_path_is_not_correct(fault, fails, tmp_path, capsys):
    out = result(tight_root(tmp_path), capsys, fault=fault)
    assert not out["correct"]
    for name in (fails, "warm_" + fails):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"], (name, out["checks"])


def test_the_control_reads_above_the_program(tmp_path, capsys):
    root = tight_root(tmp_path, "bfloat16")
    program = result(root, capsys)["checks"]
    stand_in = result(root, capsys, control="fp8")["checks"]
    assert max(stand_in[k]["value"] / program[k]["value"] for k in program) >= 3.0, (program, stand_in)


def test_reference_copy_against_the_port_and_its_dropout():
    """The reference copy's forward against the port's UNetT in float32 at
    a tiny size, dropout drawn from one generator on both sides."""
    from f5_tts_tpu_torch.config import UNetTConfig
    from f5_tts_tpu_torch.models.unett import UNetT

    P = make(unett_steps.unett_spec(CFG), 3, "cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for k in P:
            if k.endswith(".g"):
                P[k] = torch.rand(P[k].shape, generator=g) + 0.5
    model = UNetT(UNetTConfig(**CFG))
    model.load_state_dict(P, strict=True)
    x, cond = torch.randn(3, 21, 100, generator=g), torch.randn(3, 21, 100, generator=g)
    ids, t = torch.randint(-1, 256, (3, 9), generator=g), torch.rand(3, generator=g)
    with torch.no_grad():
        got = model.forward_train(x, cond, ids, t, drop_audio_cond=False, drop_text=True,
                                  generator=torch.Generator().manual_seed(6))
        drop = U.dropout_for(torch.Generator().manual_seed(6), CFG, 3, 21)
        want = U.forward_train(P, CFG, x, cond, ids, t, False, True, dropouts=drop.rows(slice(None)))
        part = U.forward_train(P, CFG, x[1:], cond[1:], ids[1:], t[1:], False, True, dropouts=drop.rows(slice(1, 3)))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert (part - want[1:]).abs().max() <= 1e-5 * want.abs().max()


def _summary(**kw):
    s = unett_steps.SkipSummary(window_s=2.0, busy_s=1.5, skip_s=0.1)
    s.kernels.update(kw)
    return s


def _readers():
    import benchmark.metrics as pkg

    return [importlib.import_module(f"benchmark.metrics.{m.name}") for m in pkgutil.iter_modules(pkg.__path__)]


def test_each_cells_readers_pass_over_the_other_cells_observation():
    steps = [{"b": 2, "n": 10, "traced": True}]
    dit_cfg = json.loads((R.HERE / "configs" / "f5tts_v1_base.json").read_text())
    unett_cfg = json.loads((R.HERE / "configs" / "e2tts_base.json").read_text())
    unett_obs = {"kind": "unett_train", "config": unett_cfg, "steps": steps, "trace": _summary(
        attn_core_fwd_kernel=[0.1, 24], flash_bwd_dkdv_wgmma_kernel=[0.1, 24], rms_norm_fwd_kernel=[0.01, 49],
        rms_norm_bwd_kernel=[0.02, 49]), "peak_window_bytes": 2**33}
    dit_obs = {"kind": "train", "config": dit_cfg, "steps": steps, "trace": Summary(window_s=2.0, busy_s=1.5,
               kernels={"attn_core_fwd_kernel": [0.1, 22]}), "peak_window_bytes": 2**33}
    for mod in _readers():
        new = mod.NAME.endswith(".unett_train")
        assert (mod.read(unett_obs) is None) != new, mod.NAME
        if new:
            assert mod.read(dit_obs) is None, mod.NAME
    # the UNetT's readers by hand
    from benchmark.metrics import (idle_unett_train, k1_roofline_unett_train, k2_roofline_unett_train,
                                   mfu_unett_train, peak_gib_unett_train, rmsnorm_roofline_unett_train,
                                   skip_unett_train)

    assert skip_unett_train.read(unett_obs) == pytest.approx(5.0)
    assert idle_unett_train.read(unett_obs) == pytest.approx(25.0)
    c = unett_cfg["unett"]
    assert k1_roofline_unett_train.read(unett_obs) == pytest.approx(
        100 * 24 * flops.least_seconds(*flops.k1_call(c, [11, 11], 11, lse=True)) / 0.1)
    assert k2_roofline_unett_train.read(unett_obs) == pytest.approx(
        100 * 24 * flops.least_seconds(*flops.k2_call(c, 2, 11)) / 0.1)
    unett_obs["trace"].kernels["attn_core_fwd_kernel"] = [0.1, 48]  # another count than a call a layer and step
    unett_obs["trace"].kernels["flash_bwd_dkdv_wgmma_kernel"] = [0.1, 23]
    assert k1_roofline_unett_train.read(unett_obs) is None and k2_roofline_unett_train.read(unett_obs) is None
    assert peak_gib_unett_train.read(unett_obs) == 8.0
    assert mfu_unett_train.read(unett_obs) == pytest.approx(
        100 * FU.train_step_flops(unett_cfg, 2, 10) / (2.0 * flops.PEAK_BF16_FLOPS))
    assert rmsnorm_roofline_unett_train.read(unett_obs) == pytest.approx(
        100 * FU.rms_norm_least_seconds(unett_cfg, 2, 10) / 0.03)
    unett_obs["trace"].kernels["rms_norm_fwd_kernel"] = [0.02, 98]  # remat's second forwards
    assert rmsnorm_roofline_unett_train.read(unett_obs) is None
    unett_obs["trace"].skip_s = 0.0
    assert skip_unett_train.read(unett_obs) is None


def test_flop_and_byte_counts_by_hand():
    c = dict(CFG)
    assert FU.layer_row_flops(c) == 2 * (4 * 64 * 64 + 2 * 64 * 256)
    assert FU.skip_row_flops(c) == 2 * 128 * 64
    assert FU.frame_flops(c) == 2 * 300 * 64 + 2 * 2 * 4 * 31 * 64 + 2 * 64 * 100
    n, b = 10, 3
    layers = 4 * FU.layer_row_flops(c) + 2 * FU.skip_row_flops(c)
    want = b * (11 * layers + 10 * FU.frame_flops(c) + 4 * 4 * 16 * 4 * 121 + 2 * (256 * 64 + 64 * 64))
    assert FU.forward_flops(c, b, n) == want and FU.train_step_flops({"unett": c}, b, n) == 3 * want
    assert FU.rms_norm_bytes(33, 64) == (2 * 2 * 33 * 64 + 4 * 64 + 4 * 33,
                                         3 * 2 * 33 * 64 + 4 * 33 + 4 * 64 + 4 * 64 * 2)
    base = json.loads((R.HERE / "configs" / "e2tts_base.json").read_text())["unett"]
    per_frame = (base["depth"] * FU.layer_row_flops(base) + 12 * FU.skip_row_flops(base) + FU.frame_flops(base))
    assert 6.6e8 < per_frame < 6.7e8  # about 663 M operations a frame outside attention


def test_forward_flops_count_every_product(monkeypatch):
    """The reference copy's forward, its products and convolutions counted
    as they run, against `forward_flops` less attention's pairs."""
    n, counted = 13, []
    real_linear, real_conv = F.linear, F.conv1d

    def linear(x, w, b=None):
        counted.append(2 * (x.numel() // x.shape[-1]) * w.shape[0] * w.shape[1])
        return real_linear(x, w, b)

    def conv1d(x, w, b=None, padding=0, groups=1):
        counted.append(2 * w.shape[0] * w.shape[1] * w.shape[2] * x.shape[-1])
        return real_conv(x, w, b, padding=padding, groups=groups)

    P = make(unett_steps.unett_spec(CFG), 1, "cpu")
    monkeypatch.setattr(F, "linear", linear)
    monkeypatch.setattr(F, "conv1d", conv1d)
    x = torch.randn(1, n, 100)
    U.forward_train(P, dict(CFG, dropout=0.0), x, x, torch.zeros(1, 4, dtype=torch.long), torch.tensor([0.3]),
                    False, False)
    attention = 4 * CFG["heads"] * CFG["dim_head"] * CFG["depth"] * (n + 1) ** 2
    assert sum(counted) == FU.forward_flops(CFG, 1, n) - attention


def test_skip_seconds_by_hand():
    ev = [{"name": STRETCH, "cat": "user_annotation", "ts": 100, "dur": 100},
          {"name": "unett.skip", "cat": "user_annotation", "ts": 110, "dur": 10},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 112, "dur": 2, "args": {"correlation": 1}},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 130, "dur": 2, "args": {"correlation": 2}},
          {"name": "gemm", "cat": "kernel", "ts": 140, "dur": 20, "args": {"correlation": 1}},
          {"name": "other", "cat": "kernel", "ts": 160, "dur": 20, "args": {"correlation": 2}}]
    assert unett_steps.skip_seconds(ev) == pytest.approx(20e-6)
    assert unett_steps.skip_seconds(ev[2:]) == 0.0
    # the backward: autograd's thread (tid 2) evaluates the nodes that the range's operators recorded (3, 4)
    bwd = unett_steps.BACKWARD
    ev = [{"name": STRETCH, "cat": "user_annotation", "ts": 100, "dur": 200, "tid": 1},
          {"name": "unett.skip", "cat": "user_annotation", "ts": 110, "dur": 10, "tid": 1},
          {"name": "aten::cat", "cat": "cpu_op", "ts": 111, "dur": 2, "tid": 1, "args": {"Sequence number": 3}},
          {"name": "aten::mm", "cat": "cpu_op", "ts": 114, "dur": 2, "tid": 1, "args": {"Sequence number": 4}},
          {"name": "aten::add", "cat": "cpu_op", "ts": 125, "dur": 2, "tid": 1, "args": {"Sequence number": 5}},
          {"name": bwd + "AddBackward0", "cat": "cpu_op", "ts": 200, "dur": 10, "tid": 2,
           "args": {"Sequence number": 5}},
          {"name": bwd + "MmBackward0", "cat": "cpu_op", "ts": 210, "dur": 10, "tid": 2,
           "args": {"Sequence number": 4}},
          {"name": bwd + "CatBackward0", "cat": "cpu_op", "ts": 220, "dur": 10, "tid": 2,
           "args": {"Sequence number": 3}},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 115, "dur": 1, "tid": 1, "args": {"correlation": 1}},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 205, "dur": 1, "tid": 2, "args": {"correlation": 2}},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 212, "dur": 1, "tid": 2, "args": {"correlation": 3}},
          {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 214, "dur": 1, "tid": 1, "args": {"correlation": 4}},
          {"name": "gemm", "cat": "kernel", "ts": 130, "dur": 10, "args": {"correlation": 1}},
          {"name": "add", "cat": "kernel", "ts": 230, "dur": 5, "args": {"correlation": 2}},
          {"name": "gemm_bwd", "cat": "kernel", "ts": 240, "dur": 30, "args": {"correlation": 3}},
          {"name": "other", "cat": "kernel", "ts": 280, "dur": 50, "args": {"correlation": 4}}]
    assert unett_steps.skip_seconds(ev) == pytest.approx(40e-6)


def test_weights_spec_matches_the_port():
    from f5_tts_tpu_torch.config import UNetTConfig
    from f5_tts_tpu_torch.models.unett import UNetT

    with torch.device("meta"):
        model = UNetT(UNetTConfig(**CFG))
    spec = {name: shape for name, shape, _, _ in unett_steps.unett_spec(CFG)}
    assert spec == {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert math.isclose(sum(math.prod(s) for s in spec.values()), sum(p.numel() for p in model.parameters()))


def test_only_the_cells_limits_decide(tmp_path, capsys):
    """A number the cell gives no limit is in the result's `numbers` and
    not among its checks (the published cell leaves out the warm step's
    loss and gradient)."""
    root = tiny.tiny_root(tmp_path)
    c = json.loads((root / "workloads" / f"{CELL}.json").read_text())
    published = json.loads((R.HERE / "workloads" / f"{CELL}.json").read_text())["limits"]
    assert set(published) == set(TIGHT) - {"warm_loss_rel_gap", "warm_grad_norm_gap"}
    tiny.write_cell(root, CELL, **dict(c, limits={k: TIGHT[k] for k in published}))
    out = result(root, capsys)
    assert out["correct"] and set(out["checks"]) == set(published) and set(out["numbers"]) == set(TIGHT)
