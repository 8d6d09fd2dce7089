"""Random weights from the seed, made on the device in one uniform and one
normal draw, keyed by the published PyTorch checkpoint names.

Linear and convolution weights and biases are U(-1/sqrt(fan_in),
1/sqrt(fan_in)), embeddings N(0, 1), the text branch's GRN gamma and beta
N(0, 0.1^2); LayerNorm weights are 1 and biases 0, as their constructors
set them. The same seed gives the
same bits on the same device, so the reference, which runs after the
program's window, makes its copy again instead of keeping one."""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *tags: int | str) -> int:
    """A 63-bit seed for one purpose of a run (`tags`), from the run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [
        t if isinstance(t, int) else int.from_bytes(t.encode()[:8].ljust(8, b"\0"), "little") & 0xFFFFFFFF
        for t in tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _linear(spec: list, name: str, out: int, inp: int, bias: bool = True) -> None:
    spec.append((name + ".weight", (out, inp), "fan_in", inp))
    if bias:
        spec.append((name + ".bias", (out,), "fan_in", inp))


def _conv(spec: list, name: str, out: int, inp_per_group: int, k: int) -> None:
    spec.append((name + ".weight", (out, inp_per_group, k), "fan_in", inp_per_group * k))
    spec.append((name + ".bias", (out,), "fan_in", inp_per_group * k))


def _norm(spec: list, name: str, dim: int) -> None:
    spec.append((name + ".weight", (dim,), "const", 1.0))
    spec.append((name + ".bias", (dim,), "const", 0.0))


def dit_spec(c: dict) -> list[tuple]:
    """(name, shape, kind, fan_in or constant) of every DiT weight."""
    s: list = []
    dim, td, inner = c["dim"], c["text_dim"], c["heads"] * c["dim_head"]
    _linear(s, "time_embed.time_mlp.0", dim, 256)
    _linear(s, "time_embed.time_mlp.2", dim, dim)
    s.append(("text_embed.text_embed.weight", (c["text_num_embeds"] + 1, td), "normal", 1.0))
    ti = td * c["conv_mult"]
    for i in range(c["conv_layers"]):
        p = f"text_embed.text_blocks.{i}."
        _conv(s, p + "dwconv", td, 1, 7)
        _norm(s, p + "norm", td)
        _linear(s, p + "pwconv1", ti, td)
        s.append((p + "grn.gamma", (1, 1, ti), "normal", 0.1))
        s.append((p + "grn.beta", (1, 1, ti), "normal", 0.1))
        _linear(s, p + "pwconv2", td, ti)
    _linear(s, "input_embed.proj", dim, 2 * c["mel_dim"] + td)
    _conv(s, "input_embed.conv_pos_embed.conv1d.0", dim, dim // 16, 31)
    _conv(s, "input_embed.conv_pos_embed.conv1d.2", dim, dim // 16, 31)
    for i in range(c["depth"]):
        p = f"transformer_blocks.{i}."
        _linear(s, p + "attn_norm.linear", 6 * dim, dim)
        for name in ("to_q", "to_k", "to_v"):
            _linear(s, p + "attn." + name, inner, dim)
        _linear(s, p + "attn.to_out.0", dim, inner)
        _linear(s, p + "ff.ff.0.0", dim * c["ff_mult"], dim)
        _linear(s, p + "ff.ff.2", dim, dim * c["ff_mult"])
    _linear(s, "norm_out.linear", 2 * dim, dim)
    _linear(s, "proj_out", c["mel_dim"], dim)
    return s


def make(spec: list[tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """float32 weights of `spec` on `device`, from one uniform and one
    normal draw of a generator seeded with `seed`."""
    n_uniform = sum(int(np.prod(shape)) for _, shape, kind, _ in spec if kind == "fan_in")
    n_normal = sum(int(np.prod(shape)) for _, shape, kind, _ in spec if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    uniform = torch.empty(n_uniform, device=device).uniform_(-1.0, 1.0, generator=gen)
    normal = torch.empty(n_normal, device=device).normal_(generator=gen)
    out, iu, inn = {}, 0, 0
    for name, shape, kind, arg in spec:
        size = int(np.prod(shape))
        if kind == "fan_in":
            out[name] = uniform[iu:iu + size].view(shape) * (1.0 / np.sqrt(arg))
            iu += size
        elif kind == "normal":
            out[name] = normal[inn:inn + size].view(shape) * arg
            inn += size
        else:
            out[name] = torch.full(shape, float(arg), device=device)
    return out
