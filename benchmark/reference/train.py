"""CFM training by the reference: F5-TTS's masked-infill flow-matching loss
(`model/cfm.py` `CFM.forward`), its gradient by autograd through the plain
DiT with its dropout, and AdamW (optax's global-norm clip, then adamw with
weight decay on every parameter, bias-corrected moments) followed by an
EMA of the weights.

A batch's loss is the squared error summed over every row's hidden span,
over the batch's span elements; the reference sums the rows' gradients a
few rows at a time (`rows` per pass), so that the float32 activations of
one pass fit beside nothing else."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as M


def span_mask(lens: torch.Tensor, frac: torch.Tensor, start_draw: torch.Tensor, n: int) -> torch.Tensor:
    """The hidden span [b, n]: floor(frac * len) frames from
    floor((len - that) * draw), inside the valid frames."""
    lengths = (frac * lens).to(torch.int32)
    start = ((lens - lengths) * start_draw).to(torch.int32).clamp(min=0)
    pos = torch.arange(n, device=lens.device)[None]
    return (pos >= start[:, None]) & (pos < (start + lengths)[:, None]) & (pos < lens[:, None])


class Dropout:
    """One training step's dropout at `rate`, drawn as the published
    training draws it on the device: a seed a block from the step's
    generator (`torch.randint` over [0, 2^62)), two seeds from that one
    (the attention's output, the feed-forward's hidden units), and each
    mask drawn from its seed over the whole batch, [b, n, width], of which
    a pass over some rows takes those rows. An element is kept where its
    uniform draw is under 1 - rate, and scaled by 1 / (1 - rate)."""

    def __init__(self, generator: torch.Generator, cfg: dict, rate: float, batch: int, n: int):
        self.rate, self.batch, self.n, self.device = rate, batch, n, generator.device
        self.widths = {"attn": cfg["heads"] * cfg["dim_head"], "ff": cfg["dim"] * cfg["ff_mult"]}
        seeds = torch.randint(0, 2**62, (cfg["depth"],), generator=generator, device=generator.device).tolist()
        self.streams = [dict(zip(("attn", "ff"), torch.randint(0, 2**62, (2,), generator=torch.Generator()
                                                               .manual_seed(s)).tolist())) for s in seeds]

    def rows(self, sl: slice) -> list:
        """One `dropout(where, x)` a block, for the batch's rows `sl`."""
        keep = 1.0 - self.rate

        def layer(streams: dict):
            def drop(where: str, x: torch.Tensor) -> torch.Tensor:
                g = torch.Generator(device=self.device).manual_seed(streams[where])
                u = torch.rand((self.batch, self.n, self.widths[where]), generator=g, device=self.device)
                kept = (u < keep)[sl]
                return torch.where(kept, x / keep, torch.zeros_like(x))
            return drop

        return [layer(s) for s in self.streams]


def forward_train(P: dict, cfg: dict, x, cond, ids, time, drop_audio: bool, drop_text: bool,
                  prec: M.Precision = M.FP32, dropouts=None) -> torch.Tensor:
    b, n = x.shape[0], x.shape[1]
    flags = torch.full((b,), drop_text, dtype=torch.bool, device=x.device)
    te = M.text_embedding(P, cfg, ids, n, flags, prec)
    t_emb = M.timestep_embedding(P, time, prec)
    audio = torch.full((b,), drop_audio, dtype=torch.bool, device=x.device)
    return M.dit(P, cfg, x, cond, te, t_emb, audio, None, prec, dropouts)


def loss_and_grads(P: dict, cfg: dict, cfm: dict, mel, ids, lens, draws: dict, rows: int = 1,
                   prec: M.Precision = M.FP32, dropout: Dropout | None = None) -> tuple[float, dict]:
    """The batch's loss and its gradient with respect to every leaf of P
    (which must require grad)."""
    n, mel_dim = mel.shape[1], mel.shape[2]
    span = span_mask(lens, draws["frac_lengths"], draws["span_start"], n)
    count = float(span.sum().item() * mel_dim)
    drop_text = bool(draws["text_drop"].item() < cfm["cond_drop_prob"])
    drop_audio = bool(draws["audio_drop"].item() < cfm["audio_drop_prob"]) or drop_text
    names = list(P)
    grads = {k: torch.zeros_like(P[k]) for k in names}
    total = 0.0
    for lo in range(0, mel.shape[0], rows):
        sl = slice(lo, lo + rows)
        x1, x0 = mel[sl].float(), draws["x0"][sl].float()
        t = draws["time"][sl].float()
        phi = (1 - t[:, None, None]) * x0 + t[:, None, None] * x1
        cond = torch.where(span[sl][..., None], torch.zeros_like(x1), x1)
        pred = forward_train(P, cfg, phi, cond, ids[sl], t, drop_audio, drop_text, prec,
                             dropout.rows(sl) if dropout else None)
        num = torch.where(span[sl][..., None], (pred - (x1 - x0)).square(), torch.zeros_like(pred)).sum()
        part = num / max(count, 1e-6)
        gs = torch.autograd.grad(part, [P[k] for k in names], allow_unused=True)
        for k, g in zip(names, gs):
            if g is not None:
                grads[k] += g
        total += float(part.item())
    return total, grads


def lr_at(count: int, lr: float, warmup: int, total: int) -> float:
    """Linear warm-up from 1e-8 to `lr`, then cosine decay to 0, in float32."""
    f = np.float32
    if count < warmup:
        frac = f(1) - f(min(max(count, 0), warmup)) / f(warmup)
        return float(f(1e-8 - lr) * frac + f(lr))
    steps = max(total - warmup, 1)
    c = f(min(count - warmup, steps))
    return float(f(lr) * (f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(steps)))))


class AdamW:
    """The clipped AdamW and EMA over a dict of float32 leaves, in place:
    from zero moments, the EMA at the leaves and `count` updates done, or
    from a `state` (dicts `mu`, `nu`, `ema` and the `count`)."""

    def __init__(self, P: dict, opt: dict, ema_decay: float, count: int = 0, state: dict | None = None):
        self.opt, self.ema_decay = opt, ema_decay
        if state is None:
            state = {"mu": {k: torch.zeros_like(v) for k, v in P.items()},
                     "nu": {k: torch.zeros_like(v) for k, v in P.items()},
                     "ema": {k: v.detach().clone() for k, v in P.items()}, "count": count}
        self.mu, self.nu, self.ema, self.count = state["mu"], state["nu"], state["ema"], state["count"]

    @torch.no_grad()
    def step(self, P: dict, grads: dict) -> dict:
        """One update; returns the gradient as the moments took it (after
        the clip)."""
        o = self.opt
        b1, b2, eps = 0.9, 0.999, 1e-8
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        factor = 1.0 if float(norm) < o["max_grad_norm"] else o["max_grad_norm"] / norm
        clipped = {k: g * factor for k, g in grads.items()}
        lr = lr_at(self.count, o["learning_rate"], o["warmup_steps"], o["total_steps"])
        self.count += 1
        for k, p in P.items():
            g = clipped[k]
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            update = (self.mu[k] / (1 - b1 ** self.count)) / (torch.sqrt(self.nu[k] / (1 - b2 ** self.count)) + eps)
            p.sub_(lr * (update + o["weight_decay"] * p))
            self.ema[k].mul_(self.ema_decay).add_(p, alpha=1 - self.ema_decay)
        return clipped
