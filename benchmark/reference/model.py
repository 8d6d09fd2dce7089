"""The F5-TTS v1 DiT as plain float32 functions over a dict of weights
keyed by the published PyTorch checkpoint names.

Following the published model (SWivid/F5-TTS `model/backbones/dit.py`,
`model/modules.py`), with the conventions that the reference keeps on
purpose:
  - attention masks keys only, and its output rows are re-zeroed by the
    padding mask; the training forward passes no mask;
  - the text branch shifts ids by +1 (padding -1 becomes the filler 0),
    adds the absolute [cos | sin] table, and re-zeroes filler positions
    after every ConvNeXt V2 block;
  - RoPE pairs adjacent channels ((d r), r = 2);
  - dropout (training) follows the attention's output projection and the
    feed-forward's GELU, as `nn.Dropout` does in the published blocks.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

MAX_POS = 4096
FP8_MAX = 448.0


class Precision:
    """How a product's inputs are rounded before a float32 matmul: "fp32"
    (not at all) or "fp8" (e4m3 with one scale a tensor). Rounding passes
    gradients straight through."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {mode}")
        self.mode = mode

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        amax = x.detach().abs().amax().clamp(min=1e-12)
        scale = FP8_MAX / amax
        r = (x.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return x + (r - x).detach()

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mode == "fp32" else self._round(x)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w if self.mode == "fp32" else self._round(w)


FP32 = Precision()


def linear(P: dict, name: str, x: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    return F.linear(prec.act(x), prec.weight(P[name + ".weight"]), P.get(name + ".bias"))


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y if weight is None else y * weight + bias


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """'same' convolution of [b, n, c] along n."""
    return F.conv1d(x.transpose(1, 2), w, b, padding=(w.shape[-1] - 1) // 2, groups=groups).transpose(1, 2)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


# ----------------------------------------------------------------- the DiT


def timestep_embedding(P: dict, t: torch.Tensor, prec: Precision) -> torch.Tensor:
    """t [m] -> [m, dim]: sinusoid of 1000 t over 256 channels, [sin | cos],
    then Linear-SiLU-Linear."""
    half = 128
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -(math.log(10000) / (half - 1)))
    arg = 1000.0 * t.float()[:, None] * freqs[None, :]
    h = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
    h = F.silu(linear(P, "time_embed.time_mlp.0", h, prec))
    return linear(P, "time_embed.time_mlp.2", h, prec)


def text_table(dim: int, device) -> torch.Tensor:
    """The absolute [cos | sin] position table [MAX_POS, dim]."""
    freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float32) / dim))
    ang = np.outer(np.arange(MAX_POS), freqs).astype(np.float32)
    return torch.tensor(np.concatenate([np.cos(ang), np.sin(ang)], axis=-1), device=device)


def text_embedding(P: dict, cfg: dict, ids: torch.Tensor, n: int, drop: torch.Tensor, prec: Precision):
    """ids [b, nt] padded with -1 -> [b, n, text_dim]; `drop` [b] bool
    replaces a row's ids by the filler."""
    b = ids.shape[0]
    tok = (ids.long() + 1)[:, :n]
    tok = F.pad(tok, (0, n - tok.shape[1]), value=0)
    filler = (tok == 0)[..., None]
    tok = torch.where(drop[:, None], torch.zeros_like(tok), tok)
    x = P["text_embed.text_embed.weight"][tok]
    pos = torch.arange(n, device=ids.device).clamp(max=MAX_POS - 1)
    x = x + text_table(cfg["text_dim"], ids.device)[pos][None]
    x = x.masked_fill(filler, 0.0)
    for i in range(cfg["conv_layers"]):
        p = f"text_embed.text_blocks.{i}."
        h = conv1d(x, P[p + "dwconv.weight"], P[p + "dwconv.bias"], groups=x.shape[-1])
        h = layer_norm(h, P[p + "norm.weight"], P[p + "norm.bias"])
        h = F.gelu(linear(P, p + "pwconv1", h, prec))
        gx = torch.sqrt(h.square().sum(dim=1, keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        h = P[p + "grn.gamma"] * (h * nx) + P[p + "grn.beta"] + h
        h = linear(P, p + "pwconv2", h, prec)
        x = (x + h).masked_fill(filler, 0.0)
    return x


def rope_tables(n: int, d: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    ang = torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv).repeat_interleave(2, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    pairs = x.unflatten(-1, (-1, 2))
    turned = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * cos + turned * sin


def attention(P: dict, p: str, x: torch.Tensor, heads: int, mask, rope, prec: Precision) -> torch.Tensor:
    b, n, _ = x.shape

    def split(t):
        return t.view(b, n, heads, -1).transpose(1, 2)

    q, k, v = (split(linear(P, p + name, x, prec)) for name in ("to_q", "to_k", "to_v"))
    cos, sin = rope
    q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    q, k, v = prec.act(q), prec.act(k), prec.act(v)
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    out = linear(P, p + "to_out.0", out.transpose(1, 2).reshape(b, n, -1), prec)
    return out if mask is None else out * mask[..., None]


def no_dropout(where: str, x: torch.Tensor) -> torch.Tensor:
    return x


def block(P: dict, i: int, x: torch.Tensor, mod: torch.Tensor, heads: int, mask, rope, prec: Precision,
          dropout=no_dropout):
    """`dropout(where, x)` drops the attention's output ("attn") and the
    feed-forward's hidden units ("ff")."""
    p = f"transformer_blocks.{i}."
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
    h = layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    x = x + gate_msa[:, None] * dropout("attn", attention(P, p + "attn.", h, heads, mask, rope, prec))
    h = layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    h = dropout("ff", F.gelu(linear(P, p + "ff.ff.0.0", h, prec), approximate="tanh"))
    return x + gate_mlp[:, None] * linear(P, p + "ff.ff.2", h, prec)


def dit(P: dict, cfg: dict, x, cond, text_embed, t_emb, drop_audio, mask=None, prec: Precision = FP32,
        dropouts=None):
    """x, cond [b, n, mel]; text_embed [b, n, text_dim]; t_emb [b or 1, dim];
    drop_audio [b] bool; mask [b, n] bool or None; `dropouts` one
    `dropout(where, x)` a block (see `block`), or None -> the flow
    [b, n, mel]."""
    cond = torch.where(drop_audio[:, None, None], torch.zeros_like(cond), cond)
    h = linear(P, "input_embed.proj", torch.cat([x, cond, text_embed], dim=-1), prec)
    c = "input_embed.conv_pos_embed.conv1d."
    pos = mish(conv1d(h, P[c + "0.weight"], P[c + "0.bias"], groups=16))
    h = h + mish(conv1d(pos, P[c + "2.weight"], P[c + "2.bias"], groups=16))
    rope = rope_tables(x.shape[1], cfg["dim_head"], x.device)
    silu = F.silu(t_emb)
    for i in range(cfg["depth"]):
        mod = linear(P, f"transformer_blocks.{i}.attn_norm.linear", silu, prec)
        h = block(P, i, h, mod, cfg["heads"], mask, rope, prec, dropouts[i] if dropouts else no_dropout)
    scale, shift = linear(P, "norm_out.linear", silu, prec).chunk(2, dim=-1)
    h = layer_norm(h) * (1 + scale[:, None]) + shift[:, None]
    return linear(P, "proj_out", h, prec)
