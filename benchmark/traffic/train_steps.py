"""CFM training steps at a frame budget: the port's `make_train_step` over
`init_train_state` (float32 master weights, compute in the configuration's
dtype, AdamW with the global-norm clip, the EMA), the step both trainers
run, fed one batch after another as fast as it takes them.

Utterance lengths are the mix's log-normal set (`pool` of them, clipped),
sorted and cut so that the longest item times the batch size stays within
`max_frames` and no batch holds more than `max_samples`; the steps take
those batches in a cycle whose order is drawn from the seed (the batch
with the longest padded length first), and every step's mel, text ids and
CFM draws and dropout generator are new, made on the device from the
seed. The window runs whole cycles, so every run trains the same
batches' shapes; the end-to-end metric is the unpadded frames it trained
over its seconds. With `after_warmup` the state starts at the schedule's
end of warm-up (its update count set to `warmup_steps`), where most of a
training run's steps are taken: the peak learning rate, no bias
correction to speak of.

Set-up builds the one train state and runs its first `check_steps` steps
through the window's own call and feed. After the window, one more step
of the same call and feed (the next batch of the cycle, a shape set-up
never ran) starts from the warm state the window left, of which a copy
is kept. The reference then follows the set-up steps from the seed, and
the warm step from that copy: each step's loss, the gradient as the
optimizer took it (from its first moment), and the changes of the
parameters and of their EMA, each leaf's norm against the reference's.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from benchmark import inputs as I
from benchmark.run import Check, Outcome
from benchmark.weights import sub_seed


class Feed:
    """The run's batches: sizes from the pool, content from the seed."""

    def __init__(self, run):
        self.run, mix = run, run.mix
        fps = run.config["audio"]["sample_rate"] / run.config["audio"]["hop_length"]
        s = mix["seconds"]
        self.lengths = (I.lognormal_set(mix["pool"], s["median"], s["sigma"], s["min"], s["max"]) * fps).astype(np.int64)
        self.batches = I.dynamic_batches(self.lengths, mix["max_frames"], mix["max_samples"])
        self.fps = fps
        order = I.rng(run.seed, "train_order").permutation(len(self.batches))
        widest = max(range(len(self.batches)), key=lambda j: self.lengths[self.batches[j]].max())
        self.order = np.concatenate([[widest], order[order != widest]])

    def lens(self, step: int) -> np.ndarray:
        """The unpadded lengths of step `step`'s batch."""
        return self.lengths[self.batches[self.order[step % len(self.order)]]]

    def generator(self, step: int) -> torch.Generator:
        """Step `step`'s generator, from which the DiT draws its dropout."""
        return torch.Generator(device=self.run.device).manual_seed(sub_seed(self.run.seed, "train_dropout", step))

    def batch(self, step: int) -> dict:
        """mel [b, n, mel] (0 past each length), text ids [b, nt] (-1 past
        each text), lens [b], and the CFM draws, on the device."""
        run, cfm = self.run, self.run.config["cfm"]
        lens = self.lens(step)
        b, n, mel_dim = len(lens), int(lens.max()), run.config["audio"]["n_mels"]
        dev = run.device
        gen = torch.Generator(device=dev).manual_seed(sub_seed(run.seed, "train_batch", step))
        lens_t = torch.as_tensor(lens, device=dev)
        frames = torch.arange(n, device=dev)[None]
        mel = torch.randn(b, n, mel_dim, generator=gen, device=dev) * 2.0 - 4.0
        mel = mel * (frames < lens_t[:, None])[..., None]
        chars = np.minimum(np.round(lens / self.fps * run.mix["chars_per_second"]).astype(np.int64), lens)
        nt = int(chars.max())
        text = torch.randint(0, 256, (b, nt), generator=gen, device=dev)
        text = torch.where(torch.arange(nt, device=dev)[None] < torch.as_tensor(chars, device=dev)[:, None],
                           text, torch.full_like(text, -1))
        lo, hi = cfm["frac_lengths_mask"]

        def uniform(*shape):
            return torch.rand(shape, generator=gen, device=dev)

        draws = {"frac_lengths": lo + (hi - lo) * uniform(b), "span_start": uniform(b),
                 "x0": torch.randn(b, n, mel_dim, generator=gen, device=dev), "time": uniform(b),
                 "audio_drop": uniform(1), "text_drop": uniform(1)}
        return {"mel": mel, "text": text, "lens": lens_t, "draws": draws, "frames": int(lens.sum()), "b": b, "n": n}


def run(run) -> Outcome:
    from f5_tts_tpu_torch.models.cfm import CFMDraws
    from f5_tts_tpu_torch.training.trainer import init_train_state, make_optimizer, make_train_step

    from benchmark.program import build_dit, cfm_config
    from benchmark.weights import dit_spec, make

    mix, config, tr = run.mix, run.config, run.config["training"]
    fault = run.fault
    dit = build_dit(config, run.seed, run.device)
    opt = make_optimizer(learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"],
                         num_warmup_steps=tr["warmup_steps"], total_steps=tr["total_steps"],
                         max_grad_norm=tr["max_grad_norm"])
    step = make_train_step(cfm_config(config), opt, ema_decay=None if fault == "ema_unchanged" else tr["ema_decay"])
    state = init_train_state(dit, opt, ema=True)
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
    losses, grads = [], {}
    for k in range(checked):
        loss, _ = train(k)
        losses.append(float(loss.item()))
        if k == 0:
            grads = norms(state.opt_state["mu"], lambda name, m: m / (1.0 - opt.b1))
    with torch.no_grad():
        start = make(dit_spec(config["dit"]), sub_seed(run.seed, "dit"), run.device)
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
    loss, _ = train(warm)
    with torch.no_grad():
        mu = state.opt_state["mu"]
        got_warm = {"losses": [float(loss.item())],
                    "grads": norms(mu, lambda n, m: (m - opt.b1 * before["mu"][n]) / (1.0 - opt.b1)),
                    "change": norms(state.params, lambda n, p: p - before["P"][n]),
                    "ema": norms(state.ema, lambda n, e: e - before["ema"][n])}

    observation = {"kind": "train", "config": config, "steps": shapes, "window_s": elapsed}
    held = {"state": state}
    extra = {"steps": k - checked, "window_s": elapsed, "losses": losses, "warm_step": warm}

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
            out += [Check(prefix + name, value, limits[prefix + name]) for name, value in numbers.items()]
            extra[prefix + "worst_leaves"] = {"grad": worst_leaves(g["grads"], r["grads"]),
                                              "update": worst_leaves(g["change"], r["change"], r["moved"]),
                                              "ema": worst_leaves(g["ema"], r["ema"], r["moved"])}
        return out

    return Outcome(end_to_end={"train_frames_per_s": (frames / elapsed, "frames/s")}, attempted=k - checked,
                   failed=0, observation=observation, release=held.clear, check=check, extra=extra)


def start_count(run) -> int:
    """The updates counted before the first step: the warm-up's length with
    `after_warmup`, else none."""
    return int(run.config["training"]["warmup_steps"]) if run.mix.get("after_warmup") else 0


def norms(tensors: dict, of) -> dict:
    """Each leaf's norm of `of(name, tensor)`."""
    return {name: float(of(name, t).norm()) for name, t in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, names=None) -> dict:
    """Each leaf's |program's norm - reference's norm|, over the larger of
    the reference leaf's norm and the median leaf's."""
    names = list(ref) if names is None else names
    median = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names}


def leaf_gap(prog: dict, ref: dict, names=None) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, names).values())


def worst_leaves(prog: dict, ref: dict, names=None, count: int = 3) -> dict:
    """The median leaf's gap, and the worst leaves' names with their gaps
    and their two norms."""
    gaps = leaf_gaps(prog, ref, names)
    worst = sorted(gaps, key=gaps.get, reverse=True)[:count]
    return {"median": float(np.median(list(gaps.values()))), "worst": [[n, gaps[n], prog[n], ref[n]] for n in worst]}


def reference_step(run, feed: Feed, k: int, P: dict, opt, prec) -> tuple[float, dict]:
    """One step of the reference on step k's batch, draws and dropout:
    its loss and the gradient as its AdamW took it (clipped)."""
    from benchmark.reference import train as T

    config, bt = run.config, feed.batch(k)
    drop = T.Dropout(feed.generator(k), config["dit"], config["dit"]["dropout"], bt["b"], bt["n"]) \
        if config["dit"]["dropout"] > 0 else None
    loss, grads = T.loss_and_grads(P, config["dit"], config["cfm"], bt["mel"], bt["text"], bt["lens"], bt["draws"],
                                   rows=max(1, run.mix["reference_frames"] // bt["n"]), prec=prec, dropout=drop)
    return loss, opt.step(P, grads)


def moved(grads: dict) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    median = float(np.median(list(grads.values())))
    return [n for n, g in grads.items() if g >= 1e-3 * median]


def reference_steps(run, feed: Feed, steps: int, precision: str = "fp32") -> dict:
    """The reference's losses, first clipped gradient's leaf norms, and
    leaf norms of the changes of the parameters and of the EMA over
    `steps` steps, from the seed's weights and batches."""
    from benchmark.reference import exact, model as M, train as T
    from benchmark.weights import dit_spec, make

    exact()
    config = run.config
    P = {k: v.clone().requires_grad_() for k, v in make(dit_spec(config["dit"]), sub_seed(run.seed, "dit"),
                                                          run.device).items()}
    opt = T.AdamW(P, config["training"], config["training"]["ema_decay"], count=start_count(run))
    losses, grads = [], {}
    for k in range(steps):
        loss, clipped = reference_step(run, feed, k, P, opt, M.Precision(precision))
        losses.append(loss)
        if k == 0:
            grads = norms(clipped, lambda n, g: g)
    start = make(dit_spec(config["dit"]), sub_seed(run.seed, "dit"), run.device)
    return {"losses": losses, "grads": grads, "moved": moved(grads),
            "change": norms(P, lambda n, p: p.detach() - start[n]), "ema": norms(opt.ema, lambda n, e: e - start[n])}


def reference_warm_step(run, feed: Feed, k: int, before: dict, precision: str = "fp32") -> dict:
    """The reference's step k from the program's state before it (`before`:
    its parameters, moments, EMA and update count): the loss, the clipped
    gradient's leaf norms, and the leaf norms of the step's changes of the
    parameters and of the EMA."""
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
