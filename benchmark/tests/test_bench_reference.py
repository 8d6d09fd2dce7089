"""Whole runs of the training cell on the CPU at a tiny size, through the
harness with its look for a card skipped: the port in float32 agrees with
the plain reference to rounding; a run whose timed path is broken
underneath comes out not correct; and the lower-precision control, the
reference in the program's place, reads well above the program in
bfloat16."""

from __future__ import annotations

import json

import pytest

from benchmark import run as R
from benchmark.tests import tiny

CELL = "f5tts_v1_base.train_38k"
LIMITS = {"loss_rel_gap": 1e-5, "grad_norm_gap": 1e-4, "update_norm_gap": 1e-3, "ema_change_gap": 1e-3}
TIGHT = dict(LIMITS, **{"warm_" + k: v for k, v in LIMITS.items()})


def result(root, cell: str, capsys, seconds: float = 1.0, **options) -> dict:
    rc = R.main(["--workload", cell, "--seed", str(2**31 + 17), "--seconds", str(seconds)], require_cuda=False,
                root=root, **options)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def tight_root(tmp_path, dtype: str = "float32"):
    root = tiny.tiny_root(tmp_path, dtype)
    c = json.loads((root / "workloads" / f"{CELL}.json").read_text())
    tiny.write_cell(root, CELL, **dict(c, limits=TIGHT))
    return root


def test_float32_port_agrees_with_the_reference(tmp_path, capsys):
    """Dropout included: the reference draws the port's masks again."""
    out = result(tight_root(tmp_path), CELL, capsys)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(TIGHT)
    assert out["failed"] == 0 and out["attempted"] >= 1 and out["warm_step"] == 3 + out["attempted"]


@pytest.mark.parametrize("fault,fails", [
    ("unchanged", "update_norm_gap"),
    ("half_batch", "update_norm_gap"),
    ("ema_unchanged", "ema_change_gap"),
])
def test_a_broken_timed_path_is_not_correct(fault, fails, tmp_path, capsys):
    """Each fault fails the set-up steps' number and the warm step's."""
    out = result(tight_root(tmp_path), CELL, capsys, fault=fault)
    assert not out["correct"], out["checks"]
    for name in (fails, "warm_" + fails):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"], (name, out["checks"])


def test_the_control_reads_above_the_program(tmp_path, capsys):
    """At the tiny size the bfloat16 program's numbers and the control's
    (the reference in the program's place, its products' inputs in fp8)
    lie apart by three times or more in one number at least, so a limit
    between them passes the one and fails the other."""
    root = tight_root(tmp_path, "bfloat16")
    program = result(root, CELL, capsys)["checks"]
    stand_in = result(root, CELL, capsys, control="fp8")["checks"]
    assert max(stand_in[k]["value"] / program[k]["value"] for k in program) >= 3.0, (program, stand_in)


def test_reference_dropout_draws_the_ports_masks():
    """A block's two masks as the port draws them from a step's generator,
    and the reference's, over the whole batch and over a pass's rows."""
    import torch

    from f5_tts_tpu_torch.models.blocks import draw_seeds, dropout, dropout_generators

    from benchmark.reference import train as T

    cfg = dict(tiny.TINY_DIT, depth=3)
    b, n, rate = 5, 7, 0.1
    seeds = draw_seeds(torch.Generator().manual_seed(9), cfg["depth"])
    ref = T.Dropout(torch.Generator().manual_seed(9), cfg, rate, b, n)
    for i in (0, 2):
        g_attn, g_ff = dropout_generators(seeds[i], 2, torch.device("cpu"))
        for where, g in (("attn", g_attn), ("ff", g_ff)):
            x = torch.randn(b, n, ref.widths[where])
            port = dropout(x, rate, g)
            assert torch.equal(ref.rows(slice(None))[i](where, x), port)
            assert torch.equal(ref.rows(slice(1, 3))[i](where, x[1:3]), port[1:3])
            assert 0 < int((port == 0).sum()) < x.numel() // 2
