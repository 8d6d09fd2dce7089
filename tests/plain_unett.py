"""E2 TTS's UNetT and its CFM loss as plain float32 PyTorch functions over a
dict of weights keyed by the published checkpoint names, for the port's
CPU tests (tests/test_torch_unett.py). It imports neither the port nor the
JAX package.

Following SWivid/F5-TTS `model/backbones/unett.py` (`UNetT.forward`),
`model/modules.py` and x_transformers' `RMSNorm`:
  t   = TimestepEmbedding(time)                 (sinusoid of 1000 t, 256 ch, Linear-SiLU-Linear)
  txt = Embedding(ids + 1, padded with 0 to n)  (the CFG drop zeroes the ids; no ConvNeXt blocks)
  h   = cat(t, InputEmbedding(x, cond, txt))    (n + 1 positions)
  layer i: skips pushed in the first half, popped and merged by
           Linear(2 dim -> dim, no bias) of cat(h, skip) in the second;
           h += Attn(RMSNorm(h)) (RoPE on the first pe_attn_head heads);
           h += FF(RMSNorm(h))   (GELU tanh)
  out = proj_out(RMSNorm(h)[:, 1:])
  RMSNorm(x) = F.normalize(x, dim=-1) * sqrt(dim) * g
Departures, on purpose:
  - dropout draws its masks as the port does (`Dropout`: a seed a layer from
    the step's generator, two seeds from it, one mask each), where the
    published `nn.Dropout` draws from the global generator;
  - the loss takes its CFM draws (span, noise, time, CFG drops) as
    arguments, and no attention mask, as the port's training forward.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def linear(P: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """'same' convolution of [b, n, c] along n."""
    return F.conv1d(x.transpose(1, 2), w, b, padding=(w.shape[-1] - 1) // 2, groups=groups).transpose(1, 2)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def rms_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return F.normalize(x, dim=-1) * math.sqrt(x.shape[-1]) * g


def timestep_embedding(P: dict, t: torch.Tensor) -> torch.Tensor:
    half = 128
    freqs = torch.exp(torch.arange(half, dtype=torch.float32) * -(math.log(10000) / (half - 1)))
    arg = 1000.0 * t.float()[:, None] * freqs[None, :]
    h = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
    return linear(P, "time_embed.time_mlp.2", F.silu(linear(P, "time_embed.time_mlp.0", h)))


def rotate(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """Interleaved-pair RoPE of x [b, h, n, d] at positions 0 .. n - 1."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    ang = torch.outer(torch.arange(n, dtype=torch.float32), inv).repeat_interleave(2, dim=-1)
    pairs = x.unflatten(-1, (-1, 2))
    turned = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * torch.cos(ang) + turned * torch.sin(ang)


def no_dropout(where: str, x: torch.Tensor) -> torch.Tensor:
    return x


def attention(P: dict, p: str, x: torch.Tensor, heads: int, rope_heads: int | None, drop) -> torch.Tensor:
    b, n, _ = x.shape
    q, k, v = (linear(P, p + name, x).view(b, n, heads, -1).transpose(1, 2) for name in ("to_q", "to_k", "to_v"))
    d = q.shape[-1]
    r = heads if rope_heads is None else rope_heads
    q = torch.cat([rotate(q[:, :r], n, d), q[:, r:]], dim=1)
    k = torch.cat([rotate(k[:, :r], n, d), k[:, r:]], dim=1)
    out = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1) @ v
    return drop("attn", linear(P, p + "to_out.0", out.transpose(1, 2).reshape(b, n, -1)))


def forward(P: dict, cfg: dict, x, cond, ids, time, drop_audio: bool, drop_text: bool, dropouts=None):
    """x, cond [b, n, mel]; ids [b, nt] padded with -1; time [b] -> the flow
    [b, n, mel]. `dropouts`: one `drop(where, x)` a layer, or None."""
    b, n = x.shape[0], x.shape[1]
    tok = F.pad((ids.long() + 1)[:, :n], (0, max(0, n - ids.shape[1])), value=0)
    if drop_text:
        tok = torch.zeros_like(tok)
    txt = P["text_embed.text_embed.weight"][tok]
    if drop_audio:
        cond = torch.zeros_like(cond)
    h = linear(P, "input_embed.proj", torch.cat([x, cond, txt], dim=-1))
    c = "input_embed.conv_pos_embed.conv1d."
    groups = 16
    pos = mish(conv1d(h, P[c + "0.weight"], P[c + "0.bias"], groups))
    h = h + mish(conv1d(pos, P[c + "2.weight"], P[c + "2.bias"], groups))
    h = torch.cat([timestep_embedding(P, time)[:, None], h], dim=1)
    depth, skips = cfg["depth"], []
    for i in range(depth):
        p = f"layers.{i}."
        drop = dropouts[i] if dropouts else no_dropout
        if i < depth // 2:
            skips.append(h)
        else:
            h = F.linear(torch.cat([h, skips.pop()], dim=-1), P[p + "0.weight"])
        h = h + attention(P, p + "2.", rms_norm(h, P[p + "1.g"]), cfg["heads"], cfg["pe_attn_head"], drop)
        ff = drop("ff", F.gelu(linear(P, p + "4.ff.0.0", rms_norm(h, P[p + "3.g"])), approximate="tanh"))
        h = h + linear(P, p + "4.ff.2", ff)
    return linear(P, "proj_out", rms_norm(h, P["norm_out.g"])[:, 1:])


class Dropout:
    """A training step's dropout at `rate` as the port draws it: a seed a
    layer from the step's generator (`torch.randint` over [0, 2^62)), two
    seeds from that one (the attention's output, the feed-forward's hidden
    units), each mask drawn from its seed over [b, n + 1, width]; an element
    is kept where its uniform draw is under 1 - rate, scaled by
    1 / (1 - rate)."""

    def __init__(self, generator: torch.Generator, depth: int, rate: float):
        self.rate = rate
        seeds = torch.randint(0, 2**62, (depth,), generator=generator).tolist()
        self.streams = [torch.randint(0, 2**62, (2,), generator=torch.Generator().manual_seed(s)).tolist()
                        for s in seeds]

    def layers(self) -> list:
        keep = 1.0 - self.rate

        def layer(streams):
            def drop(where: str, x: torch.Tensor) -> torch.Tensor:
                g = torch.Generator().manual_seed(streams[0 if where == "attn" else 1])
                kept = torch.rand(x.shape, generator=g) < keep
                return torch.where(kept, x / keep, torch.zeros_like(x))
            return drop

        return [layer(s) for s in self.streams]


def cfm_loss(P: dict, cfg: dict, cfm: dict, mel, ids, lens, draws: dict, dropouts=None) -> torch.Tensor:
    """The masked-infill flow-matching loss: the squared error of the flow
    x1 - x0 over each row's hidden span (floor(frac len) frames from
    floor((len - that) start)), over the span's elements. `draws` holds
    frac_lengths, span_start, x0, time, audio_drop and text_drop."""
    n, mel_dim = mel.shape[1], mel.shape[2]
    length = (draws["frac_lengths"] * lens).to(torch.int64)
    start = ((lens - length) * draws["span_start"]).to(torch.int64).clamp(min=0)
    pos = torch.arange(n)[None]
    span = (pos >= start[:, None]) & (pos < (start + length)[:, None]) & (pos < lens[:, None])
    drop_text = bool(draws["text_drop"].item() < cfm["cond_drop_prob"])
    drop_audio = bool(draws["audio_drop"].item() < cfm["audio_drop_prob"]) or drop_text
    x1, x0 = mel.float(), draws["x0"].float()
    t = draws["time"].float()
    phi = (1 - t[:, None, None]) * x0 + t[:, None, None] * x1
    cond = torch.where(span[..., None], torch.zeros_like(x1), x1)
    pred = forward(P, cfg, phi, cond, ids, t, drop_audio, drop_text, dropouts)
    err = torch.where(span[..., None], (pred - (x1 - x0)).square(), torch.zeros_like(pred)).sum()
    return err / max(float(span.sum()) * mel_dim, 1e-6)
