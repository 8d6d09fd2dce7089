"""The benchmark's plain reference of E2 TTS Base training: the UNetT forward
(and, by autograd, its backward) with its dropout, and the CFM loss, over a
dict of weights keyed by the published checkpoint names; AdamW and the EMA
are `train.AdamW`.

Following the published model (SWivid/F5-TTS `model/backbones/unett.py`
`UNetT.forward`, `model/modules.py`, and x_transformers' `RMSNorm`, which
unett.py imports: `F.normalize(x) * sqrt(dim) * g`), in float32 with TF32
off (`exact`), importing nothing of the program under test. The
conventions it keeps on purpose, each a departure from unett.py:
  - the text branch is the bare embedding of ids + 1 (padding -1 becomes
    the filler 0, kept: `text_mask_padding` False), with no absolute table
    (unett.py adds one only with ConvNeXt blocks, of which E2 TTS Base has
    none); the CFG drop zeroes the ids;
  - RoPE pairs adjacent channels ((d r), r = 2) over the n + 1 positions of
    the time token and the frames, on the first `pe_attn_head` heads;
  - dropout follows the attention's output projection and the
    feed-forward's GELU, as `nn.Dropout` does in the published blocks, but
    its masks are drawn as the program draws them (`train.Dropout` over
    [b, n + 1, width]), so that both compute the same function;
  - the training forward passes no attention mask.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import model as M
from benchmark.reference.train import Dropout, span_mask


def rms_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return F.normalize(x, dim=-1) * math.sqrt(x.shape[-1]) * g


def dropout_for(generator: torch.Generator, cfg: dict, batch: int, n: int) -> Dropout:
    """A step's dropout draws over the UNetT's n + 1 positions."""
    return Dropout(generator, cfg, cfg["dropout"], batch, n + 1)


def attention(P: dict, p: str, x: torch.Tensor, heads: int, rope_heads, rope, prec: M.Precision, drop):
    b, n, _ = x.shape

    def split(t):
        return t.view(b, n, heads, -1).transpose(1, 2)

    q, k, v = (split(M.linear(P, p + name, x, prec)) for name in ("to_q", "to_k", "to_v"))
    cos, sin = rope
    r = heads if rope_heads is None else rope_heads
    q = torch.cat([M.rotate(q[:, :r], cos, sin), q[:, r:]], dim=1)
    k = torch.cat([M.rotate(k[:, :r], cos, sin), k[:, r:]], dim=1)
    q, k, v = prec.act(q), prec.act(k), prec.act(v)
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    out = torch.softmax(scores, dim=-1) @ v
    return drop("attn", M.linear(P, p + "to_out.0", out.transpose(1, 2).reshape(b, n, -1), prec))


def unett(P: dict, cfg: dict, x, cond, txt, t_emb, drop_audio: bool, prec: M.Precision = M.FP32, dropouts=None):
    """x, cond [b, n, mel]; txt [b, n, text_dim]; t_emb [b, dim]; `dropouts`
    one `dropout(where, x)` a layer, or None -> the flow [b, n, mel]."""
    if drop_audio:
        cond = torch.zeros_like(cond)
    h = M.linear(P, "input_embed.proj", torch.cat([x, cond, txt], dim=-1), prec)
    c = "input_embed.conv_pos_embed.conv1d."
    pos = M.mish(M.conv1d(h, P[c + "0.weight"], P[c + "0.bias"], groups=16))
    h = h + M.mish(M.conv1d(pos, P[c + "2.weight"], P[c + "2.bias"], groups=16))
    h = torch.cat([t_emb[:, None], h], dim=1)
    rope = M.rope_tables(h.shape[1], cfg["dim_head"], x.device)
    depth, skips = cfg["depth"], []
    for i in range(depth):
        p = f"layers.{i}."
        drop = dropouts[i] if dropouts else M.no_dropout
        if i < depth // 2:
            skips.append(h)
        else:
            h = F.linear(prec.act(torch.cat([h, skips.pop()], dim=-1)), prec.weight(P[p + "0.weight"]))
        h = h + attention(P, p + "2.", rms_norm(h, P[p + "1.g"]), cfg["heads"], cfg["pe_attn_head"], rope, prec,
                          drop)
        ff = drop("ff", F.gelu(M.linear(P, p + "4.ff.0.0", rms_norm(h, P[p + "3.g"]), prec), approximate="tanh"))
        h = h + M.linear(P, p + "4.ff.2", ff, prec)
    return M.linear(P, "proj_out", rms_norm(h, P["norm_out.g"])[:, 1:], prec)


def forward_train(P: dict, cfg: dict, x, cond, ids, time, drop_audio: bool, drop_text: bool,
                  prec: M.Precision = M.FP32, dropouts=None) -> torch.Tensor:
    n = x.shape[1]
    tok = (ids.long() + 1)[:, :n]
    tok = F.pad(tok, (0, n - tok.shape[1]), value=0)
    if drop_text:
        tok = torch.zeros_like(tok)
    txt = P["text_embed.text_embed.weight"][tok]
    return unett(P, cfg, x, cond, txt, M.timestep_embedding(P, time, prec), drop_audio, prec, dropouts)


def loss_and_grads(P: dict, cfg: dict, cfm: dict, mel, ids, lens, draws: dict, rows: int = 1,
                   prec: M.Precision = M.FP32, dropout: Dropout | None = None) -> tuple[float, dict]:
    """The batch's loss and its gradient with respect to every leaf of P
    (which must require grad), `rows` rows a pass (`train.loss_and_grads`
    with the UNetT's forward)."""
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
