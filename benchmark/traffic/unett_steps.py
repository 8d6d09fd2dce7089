"""CFM training steps of E2 TTS's UNetT at a frame budget: the traffic of
`train_steps` (the same feed, the same window of whole cycles, the same
set-up and warm steps, the same numbers compared), with the port's
`UNetT` (models/unett.py) built from the configuration's `unett` block in
the DiT's place, and its own plain reference (benchmark/reference/unett.py).

Two departures from `train_steps`. The gradient compared is each leaf's
gradient norm as the step computed it (hooks on the parameters), clipped
by the whole gradient's norm as AdamW clips it, at the first set-up step
and at the warm step; `train_steps` works it out from AdamW's first moment
after the step, (mu - b1 mu_before) / (1 - b1), whose float32 rounding
(about 1e-7 of mu) exceeds most of the UNetT's warm-step leaves. The whole
norms of the set-up and warm steps go into the result (`grad_norms`). And
a number decides `correct` only where the cell gives it a limit: every
number is in the result (`numbers`), the checks are those the cell's
`limits` name. By the warm step the UNetT has collapsed, in the program
and in the float32 reference's own run alike, to predicting the target's
mean (a loss of about 5, the target's variance) behind a residual stream
of RMS in the thousands, so nearly all its gradient sits in the head and
the last skip projections (a whole norm of 0.17 to 0.71, or 2 to 55 where
the step meets a loss spike; the median leaf's 1e-7 to 2e-6 of it): the
loss and gradient numbers of the warm step read as far from the reference
in sound runs as in the controls, and the cell leaves them out (PERF.md §2).

The observation's `kind` is `unett_train`, which the DiT cell's readers
(`kind == "train"`) pass over; this cell's readers are the `*_unett_train`
modules under benchmark/metrics/. With tracing, the run's tracer also sums
the device time of the UNetT's skip merges over the traced stretch, their
forward (launched inside the `unett.skip` ranges) and their backward (the
autograd nodes those ranges recorded): the summary's `skip_s`, which a
program without such ranges leaves at 0 with no range found, and None
untraced.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass

import torch

from benchmark.run import Check, Outcome
from benchmark.spans import LAUNCH_CATS, _inside, _seconds, union
from benchmark.trace import DEVICE_CATS, STRETCH, Summary, Tracer, summarize
from benchmark.traffic.train_steps import Feed, leaf_gap, moved, norms, start_count, worst_leaves
from benchmark.weights import _conv, _linear, make, sub_seed

SKIP = "unett.skip"
BACKWARD = "autograd::engine::evaluate_function: "  # the profiler's name of a node's backward


def unett_spec(c: dict) -> list[tuple]:
    """(name, shape, kind, fan_in or constant) of every UNetT weight, by the
    published checkpoint names; the RMSNorms' g are 1, as constructed."""
    s: list = []
    dim, inner, hidden = c["dim"], c["heads"] * c["dim_head"], c["dim"] * c["ff_mult"]
    _linear(s, "time_embed.time_mlp.0", dim, 256)
    _linear(s, "time_embed.time_mlp.2", dim, dim)
    s.append(("text_embed.text_embed.weight", (c["text_num_embeds"] + 1, c["text_dim"]), "normal", 1.0))
    _linear(s, "input_embed.proj", dim, 2 * c["mel_dim"] + c["text_dim"])
    _conv(s, "input_embed.conv_pos_embed.conv1d.0", dim, dim // 16, 31)
    _conv(s, "input_embed.conv_pos_embed.conv1d.2", dim, dim // 16, 31)
    for i in range(c["depth"]):
        p = f"layers.{i}."
        if i >= c["depth"] // 2:
            _linear(s, p + "0", dim, 2 * dim, bias=False)
        s.append((p + "1.g", (dim,), "const", 1.0))
        for name in ("to_q", "to_k", "to_v"):
            _linear(s, p + "2." + name, inner, dim)
        _linear(s, p + "2.to_out.0", dim, inner)
        s.append((p + "3.g", (dim,), "const", 1.0))
        _linear(s, p + "4.ff.0.0", hidden, dim)
        _linear(s, p + "4.ff.2", dim, hidden)
    s.append(("norm_out.g", (dim,), "const", 1.0))
    _linear(s, "proj_out", c["mel_dim"], dim)
    return s


def build_unett(config: dict, seed: int, device):
    """The UNetT (float32 master weights) with the seed's weights."""
    from f5_tts_tpu_torch.config import UNetTConfig
    from f5_tts_tpu_torch.models.unett import UNetT

    with torch.device(device):
        model = UNetT(UNetTConfig(**config["unett"]))
    model.load_state_dict(make(unett_spec(config["unett"]), sub_seed(seed, "unett"), device), strict=True)
    return model


@dataclass
class SkipSummary(Summary):
    skip_s: float = 0.0  # device seconds of the skip merges, forward and backward, within the stretch


def skip_seconds(events: list[dict]) -> float:
    """The union of the device intervals (clipped to the stretch) of the
    skip merges: those whose launch starts inside a `unett.skip` range of
    the stretch (the forward), or, on the same host thread, inside the
    autograd engine's evaluation of a node that an operator inside such a
    range recorded (the backward, which autograd runs from its own thread:
    a node's `Sequence number` is the one its forward operator carries)."""
    marks = [e for e in events if e.get("name") == STRETCH and "dur" in e]
    if not marks:
        return 0.0
    w0 = min(e["ts"] for e in marks)
    w1 = max(e["ts"] + e["dur"] for e in marks)

    def by_thread(chosen) -> dict:
        out: dict = {}
        for e in chosen:
            out.setdefault(e.get("tid"), []).append((e["ts"], e["ts"] + e["dur"]))
        return {tid: union(v) for tid, v in out.items()}

    def inside(ranges: dict, e: dict) -> bool:
        return _inside(ranges.get(e.get("tid"), []), e["ts"])

    forward = by_thread(e for e in events if e.get("cat") == "user_annotation" and e.get("name") == SKIP
                        and "dur" in e and w0 <= e["ts"] < w1)
    recorded = {e["args"]["Sequence number"] for e in events if e.get("cat") == "cpu_op"
                and "Sequence number" in e.get("args", {}) and inside(forward, e)}
    backward = by_thread(e for e in events if e.get("cat") == "cpu_op" and e.get("name", "").startswith(BACKWARD)
                         and e.get("args", {}).get("Sequence number") in recorded and "dur" in e
                         and w0 <= e["ts"] < w1)
    launched = {e["args"]["correlation"] for e in events if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {}) and (inside(forward, e) or inside(backward, e))}
    return _seconds((max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)) for e in events
                    if e.get("cat") in DEVICE_CATS and e.get("args", {}).get("correlation") in launched)


class SkipTracer(Tracer):
    """The harness's tracer, whose summary also carries `skip_s`."""

    def finish(self) -> None:
        if self._prof is None or self.summary is not None:
            return
        t = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = SkipSummary(**vars(summarize(events)), skip_s=skip_seconds(events))
        self.seconds = time.perf_counter() - t


def taken(state, max_norm: float, step) -> tuple[torch.Tensor, dict, float]:
    """`step()` (one training step), with each leaf's gradient norm as
    AdamW takes it: seen by hooks on the parameters and clipped by the
    whole gradient's norm (times max_norm / norm where the norm reaches
    max_norm); and that norm. A step that computes no gradient (the
    `unchanged` fault) gives zeros."""
    seen = {}
    hooks = [p.register_hook(lambda g, n=n: seen.__setitem__(n, g.float().norm())) for n, p in state.params.items()]
    try:
        loss = step()
    finally:
        for h in hooks:
            h.remove()
    if not seen:
        return loss, {n: 0.0 for n in state.params}, 0.0
    total = float(torch.stack([seen[n] for n in state.params]).norm())
    factor = max_norm / total if 0 < max_norm <= total else 1.0
    return loss, {n: float(v) * factor for n, v in seen.items()}, total


def run(run) -> Outcome:
    from f5_tts_tpu_torch.models.cfm import CFMDraws
    from f5_tts_tpu_torch.training.trainer import init_train_state, make_optimizer, make_train_step

    from benchmark.program import cfm_config

    mix, config, tr = run.mix, run.config, run.config["training"]
    fault = run.fault
    run.tracer = SkipTracer(run.tracer.enabled)
    model = build_unett(config, run.seed, run.device)
    opt = make_optimizer(learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"],
                         num_warmup_steps=tr["warmup_steps"], total_steps=tr["total_steps"],
                         max_grad_norm=tr["max_grad_norm"])
    step = make_train_step(cfm_config(config), opt, ema_decay=None if fault == "ema_unchanged" else tr["ema_decay"])
    state = init_train_state(model, opt, ema=True)
    state.opt_state["count"] = state.step = start_count(run)
    feed = Feed(run)

    def train(k: int) -> tuple[torch.Tensor, dict]:
        bt = feed.batch(k)
        mel, text, lens, d = bt["mel"], bt["text"], bt["lens"], bt["draws"]
        if fault == "half_batch":
            h = max(1, bt["b"] // 2)
            mel, text, lens = mel[:h], text[:h], lens[:h]
            d = {key: (v[:h] if key not in ("audio_drop", "text_drop") else v) for key, v in d.items()}
        draws, gen = CFMDraws(**d), feed.generator(k)
        if fault == "unchanged":
            with torch.no_grad():
                loss = step.objective.loss(state.model, mel, text, lens, gen, draws)
        else:
            loss = step(state, mel, text, lens, generator=gen, draws=draws)
        return loss, bt

    checked = int(mix["check_steps"])
    losses, grads, grad_norms = [], {}, []
    for k in range(checked):
        loss, clipped, total = taken(state, opt.max_grad_norm, lambda: train(k)[0])
        losses.append(float(loss.item()))
        grad_norms.append(total)
        if k == 0:
            grads = clipped
    with torch.no_grad():
        start = make(unett_spec(config["unett"]), sub_seed(run.seed, "unett"), run.device)
        got_start = {"losses": losses, "grads": grads, "change": norms(state.params, lambda n, p: p - start[n]),
                     "ema": norms(state.ema, lambda n, e: e - start[n])}
        del start

    cycle = len(feed.order)
    traced_steps = range(checked + cycle, checked + 2 * cycle)  # the window's second cycle
    tracing = contextlib.ExitStack()
    t0 = run.begin_window()
    k, frames, shapes = checked, 0, []
    while time.perf_counter() - t0 < run.seconds or (k - checked) % cycle:
        if k == traced_steps[0]:
            tracing.enter_context(run.tracer.stretch())
        _, bt = train(k)
        if k == traced_steps[-1]:
            tracing.close()
        frames += bt["frames"]
        shapes.append({"b": bt["b"], "n": bt["n"], "traced": k in traced_steps})
        k += 1
    tracing.close()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    elapsed = time.perf_counter() - t0
    run.end_window()

    warm = k
    with torch.no_grad():
        before = {"P": {n: p.detach().clone() for n, p in state.params.items()},
                  "mu": {n: m.clone() for n, m in state.opt_state["mu"].items()},
                  "nu": {n: v.clone() for n, v in state.opt_state["nu"].items()},
                  "ema": {n: e.clone() for n, e in state.ema.items()}, "count": state.opt_state["count"]}
    loss, clipped, total = taken(state, opt.max_grad_norm, lambda: train(warm)[0])
    grad_norms.append(total)
    with torch.no_grad():
        got_warm = {"losses": [float(loss.item())], "grads": clipped,
                    "change": norms(state.params, lambda n, p: p - before["P"][n]),
                    "ema": norms(state.ema, lambda n, e: e - before["ema"][n])}

    observation = {"kind": "unett_train", "config": config, "steps": shapes, "window_s": elapsed}
    held = {"state": state}
    extra = {"steps": k - checked, "window_s": elapsed, "losses": losses, "warm_step": warm,
             "grad_norms": grad_norms}

    def check() -> list[Check]:
        ref = reference_steps(run, feed, checked)
        ref_warm = reference_warm_step(run, feed, warm, before)
        got, got_w = got_start, got_warm
        if run.control:
            got = reference_steps(run, feed, checked, run.control)
            got_w = reference_warm_step(run, feed, warm, before, run.control)
        extra["leaves_compared"] = [len(ref["grads"]), len(ref["moved"]), len(ref_warm["moved"])]
        limits = run.cell["limits"]
        out = []
        for prefix, g, r in (("", got, ref), ("warm_", got_w, ref_warm)):
            numbers = {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(g["losses"], r["losses"])),
                       "grad_norm_gap": leaf_gap(g["grads"], r["grads"]),
                       "update_norm_gap": leaf_gap(g["change"], r["change"], r["moved"]),
                       "ema_change_gap": leaf_gap(g["ema"], r["ema"], r["moved"])}
            extra.setdefault("numbers", {}).update({prefix + name: value for name, value in numbers.items()})
            out += [Check(prefix + name, value, limits[prefix + name]) for name, value in numbers.items()
                    if prefix + name in limits]
            extra[prefix + "worst_leaves"] = {"grad": worst_leaves(g["grads"], r["grads"]),
                                              "update": worst_leaves(g["change"], r["change"], r["moved"]),
                                              "ema": worst_leaves(g["ema"], r["ema"], r["moved"])}
        return out

    return Outcome(end_to_end={"train_frames_per_s": (frames / elapsed, "frames/s")}, attempted=k - checked,
                   failed=0, observation=observation, release=held.clear, check=check, extra=extra)


def reference_step(run, feed: Feed, k: int, P: dict, opt, prec) -> tuple[float, dict]:
    """One step of the reference on step k's batch, draws and dropout: its
    loss and the gradient as its AdamW took it (clipped)."""
    from benchmark.reference import unett as U

    cfg, bt = run.config["unett"], feed.batch(k)
    drop = U.dropout_for(feed.generator(k), cfg, bt["b"], bt["n"]) if cfg["dropout"] > 0 else None
    loss, grads = U.loss_and_grads(P, cfg, run.config["cfm"], bt["mel"], bt["text"], bt["lens"], bt["draws"],
                                   rows=max(1, run.mix["reference_frames"] // bt["n"]), prec=prec, dropout=drop)
    return loss, opt.step(P, grads)


def reference_steps(run, feed: Feed, steps: int, precision: str = "fp32") -> dict:
    """The reference's losses, first clipped gradient's leaf norms, and
    leaf norms of the changes of the parameters and of the EMA over
    `steps` steps, from the seed's weights and batches."""
    from benchmark.reference import exact, model as M, train as T

    exact()
    config = run.config
    spec, seed = unett_spec(config["unett"]), sub_seed(run.seed, "unett")
    P = {k: v.clone().requires_grad_() for k, v in make(spec, seed, run.device).items()}
    opt = T.AdamW(P, config["training"], config["training"]["ema_decay"], count=start_count(run))
    losses, grads = [], {}
    for k in range(steps):
        loss, clipped = reference_step(run, feed, k, P, opt, M.Precision(precision))
        losses.append(loss)
        if k == 0:
            grads = norms(clipped, lambda n, g: g)
    start = make(spec, seed, run.device)
    return {"losses": losses, "grads": grads, "moved": moved(grads),
            "change": norms(P, lambda n, p: p.detach() - start[n]), "ema": norms(opt.ema, lambda n, e: e - start[n])}


def reference_warm_step(run, feed: Feed, k: int, before: dict, precision: str = "fp32") -> dict:
    """The reference's step k from the program's state before it (`before`):
    the loss, the clipped gradient's leaf norms, and the leaf norms of the
    step's changes of the parameters and of the EMA."""
    from benchmark.reference import exact, model as M, train as T

    exact()
    config = run.config
    P = {n: p.clone().requires_grad_() for n, p in before["P"].items()}
    state = {"mu": {n: m.clone() for n, m in before["mu"].items()},
             "nu": {n: v.clone() for n, v in before["nu"].items()},
             "ema": {n: e.clone() for n, e in before["ema"].items()}, "count": before["count"]}
    opt = T.AdamW(P, config["training"], config["training"]["ema_decay"], state=state)
    loss, clipped = reference_step(run, feed, k, P, opt, M.Precision(precision))
    grads = norms(clipped, lambda n, g: g)
    return {"losses": [loss], "grads": grads, "moved": moved(grads),
            "change": norms(P, lambda n, p: p.detach() - before["P"][n]),
            "ema": norms(opt.ema, lambda n, e: e - before["ema"][n])}
