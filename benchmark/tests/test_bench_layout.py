"""The benchmark's files against BENCHMARK.json and its rules for names
and units, and a cell added as files alone."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

from benchmark import run as R
from benchmark.tests import tiny

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_agree(cell):
    f = json.loads((R.HERE / "workloads" / f"{cell['name']}.json").read_text())
    assert (f["config"], f["traffic"], f["chips"], f["why"]) == (cell["config"], cell["traffic"], cell["chips"],
                                                                 cell["why"])
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    mix = json.loads((R.HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert callable(importlib.import_module(f"benchmark.traffic.{mix['kind']}").run)
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_agree(config):
    f = json.loads((REPO / config["file"]).read_text())
    assert f["name"] == config["name"] and f["source"].startswith(config["source"].split(" ")[0])
    assert f["reduced"] == config["reduced"]
    assert config["file"] == f"benchmark/configs/{config['name']}.json"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_by_name(metric):
    mod = importlib.import_module("benchmark.metrics." + metric["name"].replace(".", "_"))
    assert (mod.NAME, mod.UNIT) == (metric["name"], metric["unit"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric["workloads"]) <= cells
    reported = e2e[metric["moves"]].get("workloads", sorted(cells))
    assert set(metric["workloads"]) <= set(reported)


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["workloads"] + BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [c["traffic"] for c in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_every_cell_reports_enough():
    for cell in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_a_cell_added_as_files_alone(tmp_path, capsys):
    """A cell, its configuration and its traffic mix that exist only here,
    found by name: no file of the benchmark is edited to run it."""
    root = tiny.tiny_root(tmp_path)
    cfg = json.loads((root / "configs" / "f5tts_v1_base.json").read_text())
    cfg["name"] = "only_in_this_test"
    (root / "configs" / "only_in_this_test.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "train_38k.json").read_text())
    mix.update(max_frames=400, after_warmup=False)
    (root / "traffic" / "train_small.json").write_text(json.dumps(mix))
    limits = {k: 1e-2 for k in ("loss_rel_gap", "grad_norm_gap", "update_norm_gap", "ema_change_gap")}
    tiny.write_cell(root, "only_in_this_test.train_small", config="only_in_this_test", traffic="train_small",
                    chips=1, why="test", limits=dict(limits, **{"warm_" + k: v for k, v in limits.items()}))
    rc = R.main(["--workload", "only_in_this_test.train_small", "--seed", "5", "--seconds", "0.5"],
                require_cuda=False, root=root)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["correct"] and out["attempted"] >= 1
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(out)[-1] == "checks"


def test_refuses_without_a_card(tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = tiny.tiny_root(tmp_path)
    rc = R.main(["--workload", "f5tts_v1_base.train_38k", "--seed", "1", "--seconds", "1"], root=root)
    assert rc != 0 and capsys.readouterr().out == ""
