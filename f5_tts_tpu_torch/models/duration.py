"""Transformer duration predictor (the port of the JAX package's
`models/duration.py`).

Pre-LN residual transformer blocks (no AdaLN) over the reference mel and
the text, then masked-mean pooling -> Linear -> Softplus: the total duration
in seconds. Parameter names are those of the published duration_v2 file.
Three details of the reference's forward are kept: the text embedding runs
with mask_padding=False, attention gets no mask (so its output is not
re-zeroed), and the rotary embedding covers the full head.

`duration_loss` is the training loss (the JAX package's
`duration_forward(return_loss=True)`): the cond hidden past a random prefix
of each length, then L1 against the length in seconds.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram
from f5_tts_tpu_torch.config import AudioConfig, DurationConfig
from f5_tts_tpu_torch.models import blocks as B
from f5_tts_tpu_torch.models.rope import rotary_freqs
from f5_tts_tpu_torch.parallel.mesh import group_frames, lockstep, seq_frames, seq_sum
from f5_tts_tpu_torch.utils.masks import lens_to_mask, maybe_masked_mean
from f5_tts_tpu_torch.utils.modules import apply_linear, init_parameters_, layer_norm, linear, rms_norm

FRAMES_PER_SECOND = AudioConfig().frames_per_second


class DurationBlock(nn.Module):
    """LayerNorm (no affine, eps 1e-6) -> attention -> residual, then
    LayerNorm -> feed-forward -> residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int):
        super().__init__()
        self.attn = B.Attention(dim, heads, dim_head)
        self.ff = B.FeedForward(dim, mult=ff_mult)

    def forward(self, x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor], dropout_rate: float = 0.0,
                dropout_seed: int | None = None) -> torch.Tensor:
        """`dropout_seed` (training) splits into the attention's and the
        feed-forward's dropout streams."""
        return B.run_local(self.steps(x, rope, dropout_rate, dropout_seed))

    def steps(self, x, rope, dropout_rate: float = 0.0, dropout_seed: int | None = None, rows=None, frames=None):
        """`forward` as a generator: it yields where its attention and
        feed-forward do (a shard of a tensor-parallel group, a seq slot)."""
        g_attn, g_ff = B.dropout_generators(dropout_seed, 2, x.device)
        attn = yield from self.attn.steps(layer_norm(x), mask=None, rope=rope, dropout_rate=dropout_rate,
                                          generator=g_attn, rows=rows, frames=frames)
        x = x + attn
        ff = yield from self.ff.steps(layer_norm(x), dropout_rate=dropout_rate, generator=g_ff, rows=rows,
                                      frames=frames)
        return x + ff


class DurationInputEmbedding(nn.Module):
    def __init__(self, mel_dim: int, text_dim: int, out_dim: int):
        super().__init__()
        self.proj = nn.Linear(mel_dim + text_dim, out_dim)
        self.conv_pos_embed = B.ConvPositionEmbedding(out_dim)

    def forward(self, x: torch.Tensor, text_embed: torch.Tensor) -> torch.Tensor:
        """concat(mel, text) -> proj -> conv position embedding residual."""
        x = apply_linear(self.proj, torch.cat([x, text_embed], dim=-1))
        return self.conv_pos_embed(x) + x


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight)


class DurationTransformer(nn.Module):
    def __init__(self, cfg: DurationConfig):
        super().__init__()
        self.cfg = cfg
        self.text_embed = B.TextEmbedding(
            cfg.text_num_embeds, cfg.text_dim, conv_layers=cfg.conv_layers, max_pos=cfg.max_pos,
            mask_padding=False,
        )
        self.input_embed = DurationInputEmbedding(cfg.mel_dim, cfg.text_dim, cfg.dim)
        self.transformer_blocks = nn.ModuleList(
            DurationBlock(cfg.dim, cfg.heads, cfg.dim_head, cfg.ff_mult) for _ in range(cfg.depth)
        )
        self.norm_out = RMSNorm(cfg.dim)

    def forward(self, x: torch.Tensor, text: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """mel [b, n, mel_dim], text ids [b, nt] padded with -1 -> [b, n, dim]
        in the compute dtype. Dropout runs when a generator is given and
        cfg.dropout > 0, with one seed per layer."""
        h, rope = self.train_inputs(x, text)
        rate = self.cfg.dropout
        use_dropout = generator is not None and rate > 0.0
        seeds = B.draw_seeds(generator, self.cfg.depth) if use_dropout else [None] * self.cfg.depth
        for block, seed in zip(self.transformer_blocks, seeds):
            h = block(h, rope, dropout_rate=rate, dropout_seed=seed)
        return self.norm_out(h)

    def train_inputs(self, x: torch.Tensor, text: torch.Tensor, frames=None) -> tuple:
        """The forward up to the first block: (its input [b, n, dim], RoPE's
        (cos, sin)); with `frames`, a seq slot's frames of it, as
        `DiT.train_inputs` computes them."""
        dtype = getattr(torch, self.cfg.compute_dtype)
        seq_len = x.shape[1]
        text_embed = self.text_embed(text, seq_len, False, dtype)
        h = B.embed_frames(self.input_embed, frames, x.to(dtype), text_embed)
        raw = rotary_freqs(seq_len, self.cfg.dim_head, device=x.device)
        return h, (torch.cos(raw), torch.sin(raw))


class DurationPredictor(nn.Module):
    """Seconds-scale duration predictor: `DurationTransformer`, masked mean,
    a bias-free float32 linear to one value, softplus."""

    def __init__(self, cfg: DurationConfig = DurationConfig(), audio_cfg: AudioConfig = AudioConfig()):
        super().__init__()
        self.cfg = cfg
        self.audio_cfg = audio_cfg
        self.transformer = DurationTransformer(cfg)
        self.to_pred = nn.Sequential(nn.Linear(cfg.dim, 1, bias=False))

    @classmethod
    def init(
        cls, generator: torch.Generator, cfg: DurationConfig = DurationConfig(),
        device: torch.device | str = "cuda", **kwargs,
    ) -> "DurationPredictor":
        """Random weights drawn from `generator`, which must live on `device`."""
        with torch.device(device):
            predictor = cls(cfg, **kwargs)
        init_parameters_(predictor, generator)
        return predictor

    @property
    def device(self) -> torch.device:
        return self.to_pred[0].weight.device

    @torch.no_grad()
    def forward(
        self,
        inp,  # [b, n, mel_dim] mel or [b, nw] raw wave (tensor or array)
        text,  # [b, nt] int ids padded with -1 (tensor or array)
        lens=None,  # [b] valid mel frames, default all
    ) -> torch.Tensor:
        """Predicted duration in seconds, [b] float32. A mel shorter than the
        text is zero-padded to the text's length first; frames past `lens`
        are zeroed and left out of the mean."""
        device = self.device
        inp = torch.as_tensor(inp, device=device)
        if inp.ndim == 2:
            a = self.audio_cfg
            inp = log_mel_spectrogram(inp, a.sample_rate, a.n_mels, a.n_fft, a.hop_length)
        if inp.shape[-1] != self.cfg.mel_dim:
            raise ValueError(f"input has {inp.shape[-1]} mel channels, expected {self.cfg.mel_dim}")
        text = torch.as_tensor(np.asarray(text), device=device)
        batch, seq_len = inp.shape[0], inp.shape[1]
        if seq_len < text.shape[1]:
            seq_len = text.shape[1]
            inp = F.pad(inp, (0, 0, 0, seq_len - inp.shape[1]))
        lens = torch.full((batch,), seq_len, device=device) if lens is None else torch.as_tensor(lens, device=device)
        return self.seconds(inp, text, lens)

    def seconds(self, inp: torch.Tensor, text: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """The forward on tensors (the JAX package's `duration_forward`):
        mel [b, n, mel_dim], text ids [b, nt <= n], lens [b] -> seconds [b].
        Frames past `lens` are zeroed and left out of the mean. It reads no
        value on the host, so torch.export traces it (export.py)."""
        mask = lens_to_mask(lens, inp.shape[1])
        inp = torch.where(mask[..., None], inp, torch.zeros_like(inp))
        return self.head(self.transformer(inp, text), mask)

    def head(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Masked mean of the transformer's output, the float32 linear to one
        value, softplus: seconds [b]."""
        return self.seconds_from_mean(maybe_masked_mean(x, mask))

    def seconds_from_mean(self, mean: torch.Tensor) -> torch.Tensor:
        """The float32 linear to one value and the softplus of the pooled
        output [b, dim]: seconds [b]."""
        return F.softplus(linear(mean.float(), self.to_pred[0].weight))[..., 0]


class DurationGroup:
    """One data row's duration predictor split over its tensor-parallel
    group (models/shard.py `shard_model_for_training`): one trainable shard
    a slot, the blocks run in step (parallel/mesh.py `lockstep`), the
    replicated layers computed by every slot from its own leaves, the first
    slot's output used (as `DiTGroup.forward_train`). With `seq` above 1
    the shards are row-major over (seq, model) slots, each seq slot computing
    its frames as `DiTGroup` does, and the head's masked sums join over the
    seq group (`head`)."""

    def __init__(self, shards: list["DurationPredictor"], seq: int = 1):
        self.shards = list(shards)
        self.seq = seq
        self.cfg = self.shards[0].cfg
        self.devices = [s.device for s in self.shards]

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def transformer(self, x: torch.Tensor, text: torch.Tensor, seeds=None, rows=None):
        """`DurationTransformer.forward` over the group with the layers'
        dropout seeds drawn by the caller -> the first slot's [b, n, dim];
        with `seq` above 1 a list of each seq slot's [b, n / seq, dim]."""
        model = len(self.shards) // self.seq
        frames = group_frames(self.seq, len(self.shards), x.shape[1])
        prepared = [s.transformer.train_inputs(x.to(d), text.to(d), frames=f)
                    for s, d, f in zip(self.shards, self.devices, frames)]
        hs = [h for h, _ in prepared]
        seeds = [None] * self.cfg.depth if seeds is None else seeds
        for i, seed in enumerate(seeds):
            hs = lockstep([s.transformer.transformer_blocks[i].steps(h, rope, self.cfg.dropout, seed, rows, f)
                           for s, h, (_, rope), f in zip(self.shards, hs, prepared, frames)], self.seq)
        outs = [self.shards[s].transformer.norm_out(hs[s]) for s in range(0, len(self.shards), model)]
        return outs if self.seq > 1 else outs[0]

    def head(self, x, mask: torch.Tensor) -> torch.Tensor:
        """`DurationPredictor.head`; under sequence parallelism x is the seq
        slots' outputs, and the masked mean's sums (each slot's over its
        frames) join in a counted `seq_sum` before the linear and the
        softplus, on the first slot."""
        if self.seq == 1:
            return self.shards[0].head(x, mask)
        parts = []
        for frames, xs in zip(seq_frames(self.seq, mask.shape[1]), x):
            m = frames.take(mask).to(xs.device)
            parts.append(torch.where(m[..., None], xs, torch.zeros_like(xs)).sum(dim=1))
        num = seq_sum(parts)[0]
        den = mask.sum(dim=-1).clamp(min=1).to(num.device)
        return self.shards[0].seconds_from_mean(num / den[:, None].to(num.dtype))


def duration_prefix(inp: torch.Tensor, lens: torch.Tensor, rand_frac: torch.Tensor) -> tuple:
    """The training cond: each mel kept only on a prefix floor(rand_frac *
    len) of its length; returns (the masked mel, the prefix mask [b, n])."""
    seq_len = inp.shape[1]
    rand_index = (rand_frac * lens).to(torch.int32)
    mask = lens_to_mask(lens, seq_len) & (torch.arange(seq_len, device=inp.device)[None, :] < rand_index[:, None])
    return torch.where(mask[..., None], inp, torch.zeros_like(inp)), mask


def duration_loss(
    predictor: DurationPredictor,
    inp: torch.Tensor,  # [b, n, mel_dim] mel
    text: torch.Tensor,  # [b, nt] int ids padded with -1
    lens: torch.Tensor,  # [b] int
    generator: torch.Generator | None = None,
    rand_frac: torch.Tensor | None = None,  # [b] U(0, 1), the prefix draw
    frames_per_second: float = FRAMES_PER_SECOND,
) -> torch.Tensor:
    """The L1 training loss in seconds, a float32 scalar: each cond is kept
    only on a random prefix floor(rand_frac * len) of its length, so the
    model learns the full duration from a partial clip. `rand_frac` comes in
    as a tensor when given (tests feed the JAX package's draw), else from
    `generator`, which also drives the dropout (cfg.dropout > 0)."""
    if rand_frac is None:
        rand_frac = torch.rand(inp.shape[0], generator=generator, device=generator.device).to(inp.device)
    inp, mask = duration_prefix(inp, lens, rand_frac)
    pred = predictor.head(predictor.transformer(inp, text, generator=generator), mask)
    return (pred - lens.float() / frames_per_second).abs().mean()
