"""E2 TTS's flat U-Net transformer (SWivid/F5-TTS `model/backbones/unett.py`
`UNetT`; arXiv:2406.18009), the port's second backbone, for CFM training.

It shares the DiT's time embedding, text embedding (here the bare table:
no ConvNeXt blocks, no absolute positions), input embedding with its
convolutional position embedding, attention and feed-forward (models/blocks.py),
and differs in the rest:
  - the time embedding is a token prepended to the frames (n + 1 positions,
    RoPE over all of them) and dropped before the output head;
  - each layer is pre-norm with x_transformers' RMSNorm (ops/rms_norm.py:
    `F.normalize(x) * sqrt(dim) * g`), no AdaLN;
  - the first half of the layers push their inputs, and each layer of the
    second half pops the matching one and merges it by a bias-free
    Linear(2 dim -> dim) of the concatenation (a `unett.skip`
    `record_function` range, which a running profiler records);
  - RoPE rotates only the first `pe_attn_head` heads (E2 TTS Base: head 0),
    inside K1 and K2 (`rope_heads`).
Parameter names follow the published checkpoint: `layers.{i}.0` the skip
projection (second half only), `.1` and `.3` the RMSNorms (`g`), `.2` the
attention, `.4` the feed-forward, then `norm_out.g` and `proj_out`.

`forward_train` has the DiT's contract, so models/cfm.py `cfm_loss` and
training/trainer.py `make_train_step` / `init_train_state` train it as they
train the DiT: dropout after the attention's output projection and the
feed-forward's GELU, one seed a layer from the step's generator, and
activation checkpointing of each layer with cfg.remat. Sampling, serving,
export, quantization and the grids take the DiT only: each checks for one
(models/dit.py `require_dit`) and raises ValueError on a UNetT.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from f5_tts_tpu_torch.config import UNetTConfig
from f5_tts_tpu_torch.models import blocks as B
from f5_tts_tpu_torch.models.rope import rotary_freqs
from f5_tts_tpu_torch.ops.rms_norm import rms_norm
from f5_tts_tpu_torch.utils.modules import apply_linear

SKIP_SPAN = "unett.skip"


class RMSNorm(nn.Module):
    """x_transformers' RMSNorm: `F.normalize(x) * sqrt(dim) * g`, g from 1."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.g)


class UNetT(nn.Module):
    def __init__(self, cfg: UNetTConfig):
        super().__init__()
        if cfg.depth % 2:
            raise ValueError(f"UNetT pairs its layers' skips: the depth must be even, not {cfg.depth}")
        self.cfg = cfg
        dim = cfg.dim
        self.time_embed = B.TimestepEmbedding(dim)
        self.text_embed = B.TextEmbedding(cfg.text_num_embeds, cfg.text_dim, conv_layers=0,
                                          mask_padding=cfg.text_mask_padding)
        self.input_embed = B.InputEmbedding(cfg.mel_dim, cfg.text_dim, dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                nn.Linear(2 * dim, dim, bias=False) if i >= cfg.depth // 2 else None,
                RMSNorm(dim),
                B.Attention(dim, cfg.heads, cfg.dim_head, rope_heads=cfg.pe_attn_head),
                RMSNorm(dim),
                B.FeedForward(dim, mult=cfg.ff_mult),
            ])
            for i in range(cfg.depth)
        )
        self.norm_out = RMSNorm(dim)
        self.proj_out = nn.Linear(dim, cfg.mel_dim)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def forward_train(
        self,
        x: torch.Tensor,  # [b, n, mel] noised input audio
        cond: torch.Tensor,  # [b, n, mel] masked cond audio
        text: torch.Tensor,  # [b, nt] int ids padded with -1
        time: torch.Tensor,  # [b] or scalar flow time in [0, 1]
        drop_audio_cond=False,  # bool | [b] bool
        drop_text=False,  # bool | [b] bool
        mask: torch.Tensor | None = None,  # [b, n] bool padding mask
        generator: torch.Generator | None = None,  # dropout; None = deterministic
    ) -> torch.Tensor:
        """Full backbone forward -> [b, n, mel] float32, as `DiT.forward_train`
        (the time token is kept by the mask, when there is one)."""
        cfg = self.cfg
        dtype = self.compute_dtype
        b, n = x.shape[0], x.shape[1]
        time = torch.as_tensor(time, dtype=torch.float32, device=x.device)
        if time.ndim == 0:
            time = time.expand(b)
        t_emb = self.time_embed(time, dtype)  # [b, dim]
        text_embed = self.text_embed(text, n, drop_text, dtype)
        h = self.input_embed(x.to(dtype), cond.to(dtype), text_embed, drop_audio_cond=drop_audio_cond)
        h = torch.cat([t_emb[:, None], h], dim=1)  # the time token: [b, n + 1, dim]
        if mask is not None:
            mask = torch.cat([mask.new_ones(b, 1), mask], dim=1)
        raw = rotary_freqs(n + 1, cfg.dim_head, device=x.device)
        rope = (torch.cos(raw), torch.sin(raw))
        use_dropout = generator is not None and cfg.dropout > 0.0
        seeds = B.draw_seeds(generator, cfg.depth) if use_dropout else [None] * cfg.depth
        half, skips = cfg.depth // 2, []
        for i, (layer, seed) in enumerate(zip(self.layers, seeds)):
            skip = skips.pop() if i >= half else None
            if i < half:
                skips.append(h)
            if cfg.remat:
                h = checkpoint(self._layer, layer, h, skip, mask, rope, seed, use_reentrant=False)
            else:
                h = self._layer(layer, h, skip, mask, rope, seed)
        h = self.norm_out(h)[:, 1:]
        return apply_linear(self.proj_out, h).float()

    def _layer(self, layer: nn.ModuleList, h, skip, mask, rope, seed):
        """One layer: the skip merge (second half), then the pre-norm
        attention and feed-forward with their residuals."""
        skip_proj, attn_norm, attn, ff_norm, ff = layer
        if skip is not None:
            with record_function(SKIP_SPAN):
                h = apply_linear(skip_proj, torch.cat([h, skip], dim=-1))
        rate = self.cfg.dropout
        g_attn, g_ff = B.dropout_generators(seed, 2, h.device)
        h = h + attn(attn_norm(h), mask=mask, rope=rope, dropout_rate=rate, generator=g_attn)
        return h + ff(ff_norm(h), dropout_rate=rate, generator=g_ff)
