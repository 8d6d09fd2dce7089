"""Fusion probes on the card: the counterpart of the JAX package's
`tools/fusion_probe.py`.

    PYTHONPATH=. python -m f5_tts_tpu_torch.tools.fusion_probe [attn|layer|conv|adaln|all]

Each candidate runs ITERS times in a chain, each iteration fed the previous
one's output, between two CUDA events; the time per iteration is the least
of REPS chains over ITERS. PyTorch enqueues eagerly, so the host's launch
time is included wherever the card outruns it.

  attn   K1, the unfused plain attention, `flash_bhnd_rope` (P4) and
         `flash_nhd` (P3, on q, k, v in [b, n, h, d]) at [2, 16, 1024, 64]
         bf16, and the rotary embedding as a product with `perm_matrix`
         against `apply_rotary_pos_emb` in float32;
  layer  the attention layer (dim 1024, 16 heads): `blocks.Attention` (K1),
         the projections + P4 + the output projection, the same with P3
         reading the projections in place, and the plain layer;
  conv   the grouped conv (dim 1024, k 31, 16 groups): F.conv1d with
         groups, a per-group batched conv (im2col columns and one batched
         GEMM) and the 31-tap einsum sum, with their errors;
  adaln  LayerNorm + modulate at [2, 1024, 1024] bf16: the plain chain
         against the Triton kernel `ln_modulate` (P5).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from f5_tts_tpu_torch.models.blocks import Attention
from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb, rotary_freqs
from f5_tts_tpu_torch.ops.attention import sdpa_reference
from f5_tts_tpu_torch.ops.attn_variants import flash_bhnd_rope, flash_nhd
from f5_tts_tpu_torch.ops.flash_attention import flash_attention
from f5_tts_tpu_torch.ops.ln_modulate import ln_modulate
from f5_tts_tpu_torch.tools._timing import best_ms, cuda_device
from f5_tts_tpu_torch.utils.modules import apply_linear, conv1d, init_parameters_, layer_norm

B, H, N, D = 2, 16, 1024, 64
DIM = H * D
SCALE = 1.0 / math.sqrt(D)
GROUPS, KERNEL = 16, 31
ITERS = 64
REPS = 8


def bench(body, init: torch.Tensor, label: str, reps: int = REPS) -> float:
    """ms per iteration of ITERS chained calls of `body`, least of `reps`."""

    def chain():
        c = init
        for _ in range(ITERS):
            c = body(c)

    total = best_ms(chain, reps)
    print(f"{label:46} {total / ITERS:8.4f} ms/iter   (total {total:8.2f} ms, host launch included)")
    return total / ITERS


# --------------------------------------------------------------- variants


def rope_tables(n: int, d: int, device: torch.device | str | None = None):
    """(cos, sin) [n, d] float32 of the interleaved rotary frequencies."""
    raw = rotary_freqs(n, d, device=device)
    return torch.cos(raw), torch.sin(raw)


def perm_matrix(d: int) -> np.ndarray:
    """P such that x @ P == rotate_half(x) for the interleaved-pair layout."""
    P = np.zeros((d, d), np.float32)
    for j in range(0, d, 2):
        P[j + 1, j] = -1.0
        P[j, j + 1] = 1.0
    return P


def layer_variants(attn: Attention, rope: tuple[torch.Tensor, torch.Tensor], P: torch.Tensor) -> dict:
    """name -> fn(x [b, n, dim]) for the attention layer with no mask:
    `blocks.Attention` itself (K1 with the rotation inside), the projections
    + `flash_bhnd_rope` (P4) + the output projection, the same with
    `flash_nhd` (P3) on the projections as [b, n, h, d], and the plain layer
    (rotation by `apply_rotary_pos_emb`, then `sdpa_reference`)."""
    cos, sin = rope

    def nhd(x):
        b, n, _ = x.shape
        return [apply_linear(lin, x).view(b, n, attn.heads, -1) for lin in (attn.to_q, attn.to_k, attn.to_v)]

    def heads(x):
        return [t.transpose(1, 2) for t in nhd(x)]

    def out(o):
        b, _, n, _ = o.shape
        return apply_linear(attn.to_out[0], o.transpose(1, 2).reshape(b, n, -1))

    def rope_in_kernel(x):
        q, k, v = heads(x)
        return out(flash_bhnd_rope(q, k, v, cos, sin, P, q.shape[-1] ** -0.5))

    def nhd_in_kernel(x):
        q, k, v = nhd(x)
        o = flash_nhd(q, k, v, cos, sin, P, q.shape[-1] ** -0.5)
        return apply_linear(attn.to_out[0], o.reshape(*o.shape[:2], -1))

    def plain(x):
        q, k, v = heads(x)
        q, k = apply_rotary_pos_emb(q, rope), apply_rotary_pos_emb(k, rope)
        return out(sdpa_reference(q, k, v, q.shape[-1] ** -0.5))

    return {
        "layer: current (blocks.Attention, K1)": lambda x: attn(x, rope=rope),
        "layer: projections + P4 + out projection": rope_in_kernel,
        "layer: projections + P3 ([b, n, h, d]) + out projection": nhd_in_kernel,
        "layer: plain sdpa": plain,
    }


def conv_variants(weight: torch.Tensor, bias: torch.Tensor, groups: int) -> dict:
    """name -> fn(x [b, n, c]) for the "SAME" grouped conv with `weight`
    [out, in/groups, k] and `bias` [out], each in x's dtype: F.conv1d with
    groups; the per-group dense convs as one batched GEMM over im2col
    columns; and the k-tap sum of per-group einsums."""
    out_ch, ipg, ks = weight.shape
    opg, pad = out_ch // groups, ks // 2
    wg = weight.view(groups, opg, ipg, ks)  # [g, out, in, k]

    def padded(x):  # [b, n + k - 1, g, in]
        b, n, _ = x.shape
        return F.pad(x.view(b, n, groups, ipg), (0, 0, 0, 0, pad, ks - 1 - pad))

    def grouped(x):
        return conv1d(x, weight, bias, groups=groups)

    def batched(x):
        b, n, _ = x.shape
        cols = padded(x).unfold(1, ks, 1)  # [b, n, g, in, k]
        cols = cols.permute(2, 0, 1, 3, 4).reshape(groups, b * n, ipg * ks)
        w = wg.to(x.dtype).reshape(groups, opg, ipg * ks).transpose(1, 2)  # [g, in * k, out]
        y = torch.bmm(cols, w).view(groups, b, n, opg).permute(1, 2, 0, 3).reshape(b, n, out_ch)
        return y + bias.to(x.dtype)

    def tapsum(x):
        b, n, _ = x.shape
        xp = padded(x)
        wt = wg.to(x.dtype).permute(0, 3, 2, 1)  # [g, k, in, out]
        y = torch.zeros(b, n, groups, opg, dtype=x.dtype, device=x.device)
        for t in range(ks):
            y = y + torch.einsum("bngi,gio->bngo", xp[:, t:t + n], wt[:, t])
        return y.reshape(b, n, out_ch) + bias.to(x.dtype)

    return {
        "grouped conv (F.conv1d, groups=16)": grouped,
        "grouped conv as per-group batched GEMM": batched,
        "grouped conv as 31-tap einsum sum": tapsum,
    }


# --------------------------------------------------------------- probes


def probe_attn(reps: int = REPS, device: torch.device | str = "cuda") -> dict:
    dev = cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, H, N, D, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(3))
    cos, sin = rope_tables(N, D, dev)
    P = torch.tensor(perm_matrix(D), device=dev)
    res = {
        "flash current (K1)": bench(lambda c: flash_attention(c, k, v, SCALE), q, "flash current (K1)", reps),
        "unfused (plain)": bench(lambda c: sdpa_reference(c, k, v, SCALE), q, "unfused (plain)", reps),
        "flash bhnd + in-kernel rope (P4)": bench(lambda c: flash_bhnd_rope(c, k, v, cos, sin, P, SCALE), q,
                                                  "flash bhnd + in-kernel rope (P4)", reps),
    }
    qn, kn, vn = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # [b, n, h, d]
    res["flash nhd + in-kernel rope (P3)"] = bench(lambda c: flash_nhd(c, kn, vn, cos, sin, P, SCALE), qn,
                                                   "flash nhd + in-kernel rope (P3)", reps)
    qf = q.float()
    err = (apply_rotary_pos_emb(qf, (cos, sin)) - (qf * cos + (qf @ P) * sin)).abs().max().item()
    print(f"rope-as-matmul maxerr: {err}")
    res["rope-as-matmul maxerr"] = err
    return res


def probe_layer(reps: int = REPS, device: torch.device | str = "cuda") -> dict:
    dev = cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        attn = Attention(DIM, H, D)
    init_parameters_(attn, gen)
    attn.to(torch.bfloat16)
    x = torch.randn(B, N, DIM, generator=gen, device=dev, dtype=torch.bfloat16)
    fns = layer_variants(attn, rope_tables(N, D, dev), torch.tensor(perm_matrix(D), device=dev))
    with torch.no_grad():
        res = {name: bench(fn, x, name, reps) for name, fn in fns.items()}
        ref, p4, p3 = (fn(x).float() for fn in list(fns.values())[:3])
    for label, got in (("layer ropek maxerr vs current", p4), ("layer nhd maxerr vs current", p3)):
        res[label] = (got - ref).abs().max().item()
        print(f"{label}: {res[label]}")
    return res


def probe_conv(reps: int = REPS, device: torch.device | str = "cuda") -> dict:
    dev = cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        conv = torch.nn.Conv1d(DIM, DIM, KERNEL, groups=GROUPS)
    init_parameters_(conv, gen)
    weight, bias = conv.weight.detach().to(torch.bfloat16), conv.bias.detach().to(torch.bfloat16)
    x = torch.randn(B, N, DIM, generator=gen, device=dev, dtype=torch.bfloat16)
    fns = conv_variants(weight, bias, GROUPS)
    res = {name: bench(fn, x, name, reps) for name, fn in fns.items()}
    names = list(fns)
    ref = fns[names[0]](x).float()
    for name in names[1:]:
        err = (fns[name](x).float() - ref).abs().max().item()
        print(f"conv {name} maxerr: {err}")
        res[f"{name} maxerr"] = err
    return res


def probe_adaln(reps: int = REPS, device: torch.device | str = "cuda") -> dict:
    dev = cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x, scale, shift = (torch.randn(*shape, generator=gen, device=dev, dtype=torch.bfloat16)
                       for shape in ((B, N, DIM), (B, DIM), (B, DIM)))

    def chain(c):
        return layer_norm(c, None, eps=1e-6) * (1 + scale[:, None]) + shift[:, None]

    res = {"LN+modulate: plain chain": bench(chain, x, "LN+modulate: plain chain", reps),
           "LN+modulate: triton fused (P5)": bench(lambda c: ln_modulate(c, scale, shift), x,
                                                   "LN+modulate: triton fused (P5)", reps)}
    err = (chain(x).float() - ln_modulate(x, scale, shift).float()).abs().max().item()
    print(f"ln_mod maxerr: {err}")
    res["ln_mod maxerr"] = err
    return res


PROBES = {"attn": probe_attn, "layer": probe_layer, "conv": probe_conv, "adaln": probe_adaln}


def main(which: str = "all", reps: int = REPS, device: torch.device | str = "cuda") -> dict:
    """Run one probe, or all; returns {probe: {label: ms per iteration or
    max error}}."""
    if which != "all" and which not in PROBES:
        raise SystemExit(f"usage: fusion_probe [{'|'.join(PROBES)}|all]; got {which!r}")
    dev = cuda_device(device)
    print(f"fusion probes on {torch.cuda.get_device_name(dev)}: {ITERS} chained iterations, "
          f"least of {reps} chains")
    return {name: fn(reps, dev) for name, fn in PROBES.items() if which in (name, "all")}


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "all")
