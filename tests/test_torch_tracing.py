"""The training step's profiler spans (training/trainer.py `_build_step`),
on the CPU at a tiny width with dropout, for both trainers' steps: under
`torch.profiler`, `train.step` holds each microbatch's `train.forward` and
`train.backward` and then one `train.update`; the sharded step spans each
slot's update; and a profiler recording the spans changes no number of the
step."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from f5_tts_tpu_torch import config as tcfg
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.shard import shard_train_state
from f5_tts_tpu_torch.parallel import mesh as tmesh
from f5_tts_tpu_torch.training import trainer as T
from f5_tts_tpu_torch.training.duration_trainer import make_duration_train_step

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256, text_dim=32,
            conv_layers=1, dropout=0.1)
DUR = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32, conv_layers=1, dropout=0.1)
FPS = 24_000 / 256
NAMES = ("train.step", "train.forward", "train.backward", "train.update")
OBJECTIVES = ("cfm", "duration")
CPU = torch.device("cpu")


def _setup(grad_accum: int, objective: str = "cfm"):
    torch.manual_seed(0)
    opt = T.make_optimizer(1e-3, 1e-2, 0, 100)
    if objective == "cfm":
        model = DiT(tcfg.DiTConfig(**TINY))
        step = T.make_train_step(tcfg.CFMConfig(), opt, ema_decay=0.9, grad_accum=grad_accum)
    else:
        model = DurationPredictor(tcfg.DurationConfig(**DUR))
        step = make_duration_train_step(opt, FPS, ema_decay=0.9, grad_accum=grad_accum)
    state = T.init_train_state(model, opt, ema=True)
    g = torch.Generator().manual_seed(1)
    b = 2 * grad_accum
    mel = torch.randn(b, 48, 100, generator=g)
    text = torch.randint(0, 255, (b, 20), generator=g)
    text[0, 12:] = -1
    lens = torch.full((b,), 48)
    lens[-1] = 39
    return state, step, T.split_microbatches(grad_accum, mel, text, lens)


def _train(grad_accum: int, steps: int, objective: str):
    state, step, inputs = _setup(grad_accum, objective)
    losses = [step(state, *inputs, generator=T.step_generator(CPU, 3, i)) for i in range(steps)]
    return losses, state


def _annotations(prof, tmp_path) -> list[tuple[float, float, str]]:
    """The program's spans in the profiler's chrome trace: (start, end,
    name) in start order, outer before inner."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") in NAMES),
                  key=lambda s: (s[0], -s[1]))


def _profiled(grad_accum: int, steps: int, objective: str, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _train(grad_accum, steps, objective)
    return out, _annotations(prof, tmp_path)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_the_step_holds_its_parts_in_order(objective, grad_accum, tmp_path):
    _, found = _profiled(grad_accum, 2, objective, tmp_path)
    steps = [s for s in found if s[2] == "train.step"]
    assert len(steps) == 2
    for a, b, _ in steps:
        inner = [s for s in found if s[2] != "train.step" and a <= s[0] and s[1] <= b]
        assert [s[2] for s in inner] == ["train.forward", "train.backward"] * grad_accum + ["train.update"]
        assert all(x[1] <= y[0] for x, y in zip(inner, inner[1:]))  # one after another, none nested
    assert len(found) == 2 * (2 + 2 * grad_accum)


def test_the_sharded_step_spans_each_slot_update(tmp_path):
    state, step, inputs = _setup(1)
    mesh = tmesh.create_mesh(data=2, devices=[CPU, CPU])
    state = shard_train_state(state, mesh)
    sharded = tmesh.shard_train_step(step, mesh, state)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sharded(state, *inputs, T.step_generator(CPU, 3, 0))
    assert [s[2] for s in _annotations(prof, tmp_path)] == ["train.update"] * 2


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_a_profiler_changes_no_number(objective, grad_accum, tmp_path):
    """Two steps with dropout, with a profiler recording the spans and
    without one: the losses, parameters, moments and EMA are the same to
    the bit."""
    plain_losses, plain = _train(grad_accum, 2, objective)
    (traced_losses, traced), found = _profiled(grad_accum, 2, objective, tmp_path)
    assert len(found) == 2 * (2 + 2 * grad_accum)
    assert all(torch.equal(a, b) for a, b in zip(traced_losses, plain_losses))
    assert traced.step == plain.step == 2 and traced.opt_state["count"] == plain.opt_state["count"] == 2
    for name, p in plain.params.items():
        assert torch.equal(traced.params[name], p), name
        for key in ("mu", "nu"):
            assert torch.equal(traced.opt_state[key][name], plain.opt_state[key][name]), (key, name)
        assert torch.equal(traced.ema[name], plain.ema[name]), name
