"""DiT building blocks (the port of the JAX package's `models/blocks.py`).

Each block is an nn.Module whose parameter names are those of the published
PyTorch checkpoint (`time_embed.time_mlp.0.weight`, `attn.to_out.0.bias`,
...), so a snapshot's tensors load by name. The forward passes call the
primitives of utils/modules.py, which cast each weight to the activation's
dtype, as the JAX package does. Every linear goes through `apply_linear`, so
a float `nn.Linear` and a weight-only quantized `QuantizedLinear`
(models/quant.py) are interchangeable.

Dropout runs only in training, where a block is given a dropout seed (one
draw of the training generator) and the rate is above 0; the sampling paths
pass none.

Tensor parallelism (parallel/mesh.py): the attention, the feed-forward and
the DiT block each have `steps`, their forward written as a generator,
which `forward` runs to its end (`run_local`). In a shard of a
tensor-parallel group (`tp` above 1) it stops at each row-parallel linear
(`row_parallel`) to yield its partial output and is sent the group's sum;
the slots of a group run in step under `mesh.lockstep`. With tp 1 nothing
yields, and the launches and bits are those of the plain module. In a
sharded training step the row-parallel sum is an autograd function
(parallel/mesh.py `RowSum`), and dropout applies each slot's slice of the
unsharded mask (`dropout`'s `rows`, `cols` and `frames`). Under sequence
parallelism (`frames`, parallel/mesh.py `Frames`) a slot's attention also
yields its keys and values for its seq group's gather, and attends with
its queries at their offset against the whole sequence's keys.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from f5_tts_tpu_torch.models.rope import get_pos_embed_indices, precompute_freqs_cis
from f5_tts_tpu_torch.ops.attention import scaled_dot_product_attention
from f5_tts_tpu_torch.ops.ln_modulate import ln_modulate
from f5_tts_tpu_torch.utils.modules import apply_linear, cast, conv1d, embedding, gelu, layer_norm, linear, mish


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator, rows=None,
            cols: tuple[int, int] | None = None, frames=None) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), else zeroed; the keep mask is drawn from
    `generator`, which must live on x's device.

    In a shard of a sharded training step, x is a slice of the unsharded
    tensor and gets that slice of the unsharded mask: the mask is drawn at
    the global batch's size and `rows` (parallel/mesh.py `Rows`: the global
    batch and this data row's first row) kept, `cols` = (ways, index)
    keeps the index-th of `ways` column blocks of the last dim (a
    tensor-parallel slot's hidden units), and `frames` (parallel/mesh.py
    `Frames`) a seq slot's frames of dim 1."""
    keep = 1.0 - rate
    shape = list(x.shape)
    if rows is not None:
        shape[0] = rows.batch
    if frames is not None:
        shape[1] = frames.total
    if cols is not None:
        shape[-1] *= cols[0]
    kept = torch.rand(shape, generator=generator, device=x.device) < keep
    if rows is not None:
        kept = kept[rows.start:rows.start + x.shape[0]]
    if frames is not None:
        kept = frames.take(kept)
    if cols is not None:
        kept = kept.chunk(cols[0], dim=-1)[cols[1]]
    return torch.where(kept, x / keep, torch.zeros_like(x))


def dropout_generators(seed: int | None, count: int, device: torch.device) -> list[torch.Generator | None]:
    """`count` independent generators on `device` from one seed (a draw of
    the training generator), or `count` Nones without a seed. A block that
    builds its generators from a seed draws the same masks when it is run
    again, which activation checkpointing relies on."""
    if seed is None:
        return [None] * count
    seeds = torch.randint(0, 2**62, (count,), generator=torch.Generator().manual_seed(seed)).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def draw_seeds(generator: torch.Generator, count: int) -> list[int]:
    """`count` seeds drawn from `generator` (one host read for a CUDA
    generator)."""
    return torch.randint(0, 2**62, (count,), generator=generator, device=generator.device).tolist()


def as_batch_flag(flag, batch: int, device: torch.device) -> torch.Tensor:
    """A drop flag (Python bool or [b] bool tensor) as a bool tensor [b].
    Per-sample flags let cond and uncond CFG streams share one forward."""
    flag = torch.as_tensor(flag, dtype=torch.bool, device=device)
    return flag.expand(batch) if flag.ndim == 0 else flag


def run_local(steps):
    """The value of a forward written as a generator (a module's `steps`)
    that runs on its own. A module that is not a shard of a tensor-parallel
    group never yields; a shard runs under parallel/mesh.py `lockstep`."""
    try:
        next(steps)
    except StopIteration as done:
        return done.value
    raise RuntimeError("a tensor-parallel shard runs under parallel.mesh.lockstep, not on its own")


def row_parallel(layer: nn.Module, x: torch.Tensor):
    """A generator: this slot's share of a row-parallel linear, whose input
    x holds the slot's slice of the features. It yields ("sum", the partial
    product without the bias), is sent the partials' sum over the
    tensor-parallel group, and returns it plus the bias, added once, in the
    activations' dtype, as the JAX linear adds it after the product. A
    quantized or W8A8 linear runs its own `row_parallel`."""
    if not isinstance(layer, nn.Linear):
        return (yield from layer.row_parallel(x))
    total = yield "sum", linear(x, layer.weight)
    return total if layer.bias is None else total + cast(layer.bias, total.dtype)


class LayerNorm(nn.Module):
    """Affine LayerNorm with float32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


# ------------------------------------------------------------ timestep embed


def sinus_position_embedding(x: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding in float32, [sin|cos] concat."""
    half_dim = dim // 2
    emb = math.log(10000) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=x.device) * -emb)
    emb = scale * x.float()[:, None] * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, freq_embed_dim: int = 256):
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        self.time_mlp = nn.Sequential(nn.Linear(freq_embed_dim, dim), nn.SiLU(), nn.Linear(dim, dim))

    def forward(self, timestep: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """t [m] -> [m, dim]; the sinusoid is float32, the MLP runs in dtype."""
        h = sinus_position_embedding(timestep, self.freq_embed_dim).to(dtype)
        return apply_linear(self.time_mlp[2], F.silu(apply_linear(self.time_mlp[0], h)))


# ------------------------------------------------------------ conv pos embed


class ConvPositionEmbedding(nn.Module):
    """Two grouped k31 conv1d + Mish."""

    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16):
        super().__init__()
        self.groups = groups
        self.conv1d = nn.Sequential(
            nn.Conv1d(dim, dim, kernel_size, groups=groups), nn.Mish(),
            nn.Conv1d(dim, dim, kernel_size, groups=groups), nn.Mish(),
        )

    @property
    def reach(self) -> int:
        """How many frames each way an output frame depends on: each "same"
        convolution reaches (k - 1) / 2 (30 for the two k31 ones)."""
        return sum((c.kernel_size[0] - 1) // 2 for c in (self.conv1d[0], self.conv1d[2]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2 = self.conv1d[0], self.conv1d[2]
        out = mish(conv1d(x, c1.weight, c1.bias, groups=self.groups))
        return mish(conv1d(out, c2.weight, c2.bias, groups=self.groups))


# ------------------------------------------------------------ ConvNeXt V2


class GRN(nn.Module):
    """Global response normalization over the sequence axis, norms in float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gx = torch.sqrt(x.float().square().sum(dim=1, keepdim=True))
        nx = (gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
        return self.gamma.to(x.dtype) * (x * nx) + self.beta.to(x.dtype) + x


class ConvNeXtV2Block(nn.Module):
    """dwconv k7 -> LN -> pwconv -> GELU -> GRN -> pwconv -> residual."""

    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = conv1d(x, self.dwconv.weight, self.dwconv.bias, groups=x.shape[-1], padding=3)
        x = self.norm(x)
        x = gelu(apply_linear(self.pwconv1, x), approximate=False)
        x = self.grn(x)
        x = apply_linear(self.pwconv2, x)
        return residual + x


# ------------------------------------------------------------ text embedding


class TextEmbedding(nn.Module):
    def __init__(
        self,
        text_num_embeds: int,
        text_dim: int,
        conv_layers: int = 0,
        conv_mult: int = 2,
        max_pos: int = 4096,
        mask_padding: bool = True,
    ):
        super().__init__()
        self.text_embed = nn.Embedding(text_num_embeds + 1, text_dim)
        self.text_blocks = nn.ModuleList(
            ConvNeXtV2Block(text_dim, text_dim * conv_mult) for _ in range(conv_layers)
        )
        self.max_pos = max_pos
        self.mask_padding = mask_padding
        # absolute [cos|sin] position table: a constant, not a checkpoint tensor
        self.register_buffer(
            "freqs_cis", torch.tensor(precompute_freqs_cis(text_dim, max_pos)), persistent=False
        )

    def forward(self, text: torch.Tensor, seq_len: int, drop_text, dtype: torch.dtype) -> torch.Tensor:
        """Text ids [b, nt] padded with -1 -> [b, seq_len, text_dim].

        The ids shift by +1 so -1 padding becomes the filler token 0; the CFG
        text drop zeroes the *shifted* ids; the ConvNeXt blocks see the
        absolute position table, and padding is re-zeroed after each block."""
        batch, text_len = text.shape
        text = (text.long() + 1)[:, :seq_len]
        if seq_len > text_len:
            text = F.pad(text, (0, seq_len - text_len), value=0)
        text_mask = (text == 0)[..., None]  # True = filler/padding

        drop = as_batch_flag(drop_text, batch, text.device)
        text = torch.where(drop[:, None], torch.zeros_like(text), text)
        x = embedding(self.text_embed.weight, text, dtype=dtype)

        if len(self.text_blocks) > 0:
            pos_idx = get_pos_embed_indices(
                torch.zeros(batch, dtype=torch.long, device=text.device), seq_len, self.max_pos
            )
            x = x + self.freqs_cis.to(dtype)[pos_idx]
            if self.mask_padding:
                x = x.masked_fill(text_mask, 0.0)
                for block in self.text_blocks:
                    x = block(x).masked_fill(text_mask, 0.0)
            else:
                for block in self.text_blocks:
                    x = block(x)
        return x


# ------------------------------------------------------------ input embedding


def embed_frames(embed: nn.Module, frames, *seqs: torch.Tensor, **kw) -> torch.Tensor:
    """A seq slot's frames of an input embedding (`InputEmbedding` or the
    duration predictor's) of whole-sequence inputs [b, n, ...]: the
    embedding runs on the window that its convolutions reach around the
    slot's frames (parallel/mesh.py `Frames.window`, clipped to the
    sequence), and the slot's frames are kept, equal to the whole
    sequence's. Without `frames`, the whole embedding."""
    if frames is None:
        return embed(*seqs, **kw)
    lo, hi = frames.window(embed.conv_pos_embed.reach)
    out = embed(*(t[:, lo:hi] for t in seqs), **kw)
    return out[:, frames.start - lo:frames.stop - lo]


class InputEmbedding(nn.Module):
    def __init__(self, mel_dim: int, text_dim: int, out_dim: int):
        super().__init__()
        self.proj = nn.Linear(mel_dim * 2 + text_dim, out_dim)
        self.conv_pos_embed = ConvPositionEmbedding(out_dim)

    def forward(self, x, cond, text_embed, drop_audio_cond=False) -> torch.Tensor:
        """concat(x, cond, text) -> proj -> conv position embedding residual."""
        drop = as_batch_flag(drop_audio_cond, x.shape[0], x.device)
        cond = torch.where(drop[:, None, None], torch.zeros_like(cond), cond)
        x = apply_linear(self.proj, torch.cat([x, cond, text_embed], dim=-1))
        return self.conv_pos_embed(x) + x


# ------------------------------------------------------------ attention


class Attention(nn.Module):
    """Non-causal multi-head attention with RoPE and a key-padding mask.

    `heads` is the local head count: a shard of a tensor-parallel group
    (parallel/mesh.py) holds heads / tp of them, and its `to_out` is
    row-parallel: `steps` yields its partial output for the group's sum
    and adds the bias once, after it (`row_parallel`). With tp 1 it runs
    as a plain module. `rope_heads` rotates only the first heads (E2 TTS's
    UNetT: its `pe_attn_head`); None rotates every head."""

    def __init__(self, dim: int, heads: int, dim_head: int, rope_heads: int | None = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.rope_heads = rope_heads
        self.tp, self.tp_index = 1, 0
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(
        self,
        x: torch.Tensor,  # [b, n, dim]
        mask: torch.Tensor | None = None,  # [b, n] bool
        rope: tuple[torch.Tensor, torch.Tensor] | None = None,  # (cos, sin) [n, dim_head]
        dropout_rate: float = 0.0,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Scale 1/sqrt(dim_head); keys masked only; dropout on the output
        projection (with a generator and a rate above 0); output rows
        re-zeroed by the mask. q, k and v reach attention as strided
        [b, h, n, d] views of the projections, and its output reshapes back
        without a copy."""
        return run_local(self.steps(x, mask, rope, dropout_rate, generator))

    def steps(self, x, mask=None, rope=None, dropout_rate: float = 0.0, generator=None, rows=None, frames=None):
        """`forward` as a generator, which yields with tp above 1 and under
        sequence parallelism. `rows`: a data row's place in a sharded
        step's batch (`dropout`); the dropout after `to_out` is full width,
        the same on every slot. `frames` (parallel/mesh.py `Frames`, more
        than one way): x holds a seq slot's frames, and `mask` and `rope`
        are the whole sequence's; the slot yields ("gather", its k and v
        side by side [b, n_slot, 2 inner]) and is sent the seq group's
        [b, n, 2 inner], attends with its queries at their offset
        (`q_offset`: a query block) and re-zeroes its own rows."""
        b, n, _ = x.shape

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, t.shape[1], self.heads, -1).transpose(1, 2)

        q = heads(apply_linear(self.to_q, x))
        offset, row_mask = 0, mask
        if frames is not None and frames.ways > 1:
            kv = yield "gather", torch.cat([apply_linear(self.to_k, x), apply_linear(self.to_v, x)], dim=-1)
            k, v = (heads(t) for t in kv.chunk(2, dim=-1))
            offset = frames.start
            row_mask = None if mask is None else frames.take(mask)
        else:
            k, v = heads(apply_linear(self.to_k, x)), heads(apply_linear(self.to_v, x))
        out = scaled_dot_product_attention(
            q, k, v, 1.0 / math.sqrt(q.shape[-1]), key_mask=mask, rope=rope, q_offset=offset,
            rope_heads=self.rope_heads,
        )
        out = out.transpose(1, 2).reshape(b, n, -1)
        if self.tp > 1:
            out = yield from row_parallel(self.to_out[0], out)
        else:
            out = apply_linear(self.to_out[0], out)
        if generator is not None and dropout_rate > 0.0:
            out = dropout(out, dropout_rate, generator, rows, frames=frames)
        if row_mask is not None:
            out = out * row_mask[..., None].to(out.dtype)
        return out


# ------------------------------------------------------------ feed forward


class FeedForward(nn.Module):
    """Linear -> GELU(tanh) -> dropout (in training) -> Linear. A shard of a
    tensor-parallel group holds hidden / tp units and its second linear is
    row-parallel, as the attention's `to_out`."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.tp, self.tp_index = 1, 0
        # index 1 holds the reference's dropout slot, so checkpoint names line up
        self.ff = nn.Sequential(
            nn.Sequential(nn.Linear(dim, inner), nn.GELU(approximate="tanh")),
            nn.Identity(),
            nn.Linear(inner, dim),
        )

    def forward(self, x: torch.Tensor, dropout_rate: float = 0.0, generator: torch.Generator | None = None) -> torch.Tensor:
        return run_local(self.steps(x, dropout_rate, generator))

    def steps(self, x, dropout_rate: float = 0.0, generator=None, rows=None, frames=None):
        """`forward` as a generator, which yields only with tp above 1. A
        slot's hidden dropout is its columns (and frames) of the unsharded
        mask."""
        h = gelu(apply_linear(self.ff[0][0], x), approximate=True)
        if generator is not None and dropout_rate > 0.0:
            h = dropout(h, dropout_rate, generator, rows, (self.tp, self.tp_index) if self.tp > 1 else None, frames)
        if self.tp > 1:
            return (yield from row_parallel(self.ff[2], h))
        return apply_linear(self.ff[2], h)


# ------------------------------------------------------------ AdaLN-Zero


class AdaLayerNormZero(nn.Module):
    def __init__(self, dim: int, chunks: int = 6):
        super().__init__()
        self.linear = nn.Linear(dim, dim * chunks)

    def mods(self, emb: torch.Tensor) -> torch.Tensor:
        """time embedding -> SiLU -> Linear(chunks * dim) modulation vector."""
        return apply_linear(self.linear, F.silu(emb))

    def forward(self, x: torch.Tensor, mod: torch.Tensor):
        """Split order: shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
        gate_mlp; `mod` is [b or 1, 6 * dim]."""
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        return ln_modulate(x, scale_msa, shift_msa), gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroFinal(AdaLayerNormZero):
    def __init__(self, dim: int):
        super().__init__(dim, chunks=2)

    def forward(self, x: torch.Tensor, mod: torch.Tensor) -> torch.Tensor:
        """Scale and shift only; split order scale, shift."""
        scale, shift = mod.chunk(2, dim=-1)
        return ln_modulate(x, scale, shift)


# ------------------------------------------------------------ DiT block


class DiTBlock(nn.Module):
    """AdaLN-Zero -> attention -> gated residual -> modulated FF -> gated residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int):
        super().__init__()
        self.attn_norm = AdaLayerNormZero(dim)
        self.attn = Attention(dim, heads, dim_head)
        self.ff = FeedForward(dim, mult=ff_mult)

    def forward(self, x, mod, mask=None, rope=None, dropout_rate: float = 0.0, dropout_seed: int | None = None):
        """`mod` is [b or 1, 6 * dim]; `dropout_seed` (training) splits into
        the attention's and the feed-forward's dropout streams."""
        return run_local(self.steps(x, mod, mask, rope, dropout_rate, dropout_seed))

    def steps(self, x, mod, mask=None, rope=None, dropout_rate: float = 0.0, dropout_seed: int | None = None,
              rows=None, frames=None):
        """`forward` as a generator: it yields where its attention and
        feed-forward do (a shard of a tensor-parallel group, a seq slot)."""
        g_attn, g_ff = dropout_generators(dropout_seed, 2, x.device)
        norm, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.attn_norm(x, mod)
        attn = yield from self.attn.steps(norm, mask=mask, rope=rope, dropout_rate=dropout_rate, generator=g_attn,
                                          rows=rows, frames=frames)
        x = x + gate_msa[:, None] * attn
        norm = ln_modulate(x, scale_mlp, shift_mlp)
        ff = yield from self.ff.steps(norm, dropout_rate=dropout_rate, generator=g_ff, rows=rows, frames=frames)
        return x + gate_mlp[:, None] * ff
