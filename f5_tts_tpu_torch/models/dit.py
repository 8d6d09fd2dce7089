"""Diffusion Transformer backbone (the port of the JAX package's `models/dit.py`).

The JAX functions map to methods of `DiT`:
  - `dit_text_embed`          -> `DiT.embed_text`
  - `dit_time_mods`           -> `DiT.time_mods`
  - `dit_forward_precomputed` -> `DiT.forward`
The depth dimension is a ModuleList walked in Python; the output is float32.
"""

from __future__ import annotations

import torch
from torch import nn

from f5_tts_tpu_torch.config import DiTConfig
from f5_tts_tpu_torch.models import blocks as B
from f5_tts_tpu_torch.models.rope import rotary_freqs
from f5_tts_tpu_torch.utils.modules import apply_linear


class DiT(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.time_embed = B.TimestepEmbedding(cfg.dim)
        self.text_embed = B.TextEmbedding(
            cfg.text_num_embeds, cfg.text_dim, conv_layers=cfg.conv_layers,
            conv_mult=cfg.conv_mult, max_pos=cfg.max_pos, mask_padding=cfg.text_mask_padding,
        )
        self.input_embed = B.InputEmbedding(cfg.mel_dim, cfg.text_dim, cfg.dim)
        self.transformer_blocks = nn.ModuleList(
            B.DiTBlock(cfg.dim, cfg.heads, cfg.dim_head, cfg.ff_mult) for _ in range(cfg.depth)
        )
        self.norm_out = B.AdaLayerNormZeroFinal(cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.mel_dim)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def embed_text(self, text: torch.Tensor, seq_len: int, drop_text=False) -> torch.Tensor:
        """Text branch only -> [b, seq_len, text_dim]. It is constant across
        ODE steps, so the sampler computes it once per request."""
        return self.text_embed(text, seq_len, drop_text, self.compute_dtype)

    def time_mods(self, times: torch.Tensor) -> dict:
        """The time conditioning of a batch of flow times `times` [m]:
        {"blocks": [m, depth, 1, 6*dim], "final": [m, 1, 2*dim]}. The sampler's
        evaluation times are known up front, so it computes every step's
        AdaLN modulations before integrating."""
        t_emb = self.time_embed(times, self.compute_dtype)  # [m, dim]
        blocks = torch.stack([blk.attn_norm.mods(t_emb) for blk in self.transformer_blocks], dim=1)
        return {"blocks": blocks[:, :, None, :], "final": self.norm_out.mods(t_emb)[:, None, :]}

    def forward(
        self,
        x: torch.Tensor,  # [b, n, mel] noised input audio
        cond: torch.Tensor,  # [b, n, mel] masked cond audio
        text_embed: torch.Tensor,  # [b, n, text_dim] from embed_text
        time_mods: dict,  # one time_mods slice: {"blocks": [depth, 1, 6*dim], "final": [1, 2*dim]}
        drop_audio_cond=False,  # bool | [b] bool
        mask: torch.Tensor | None = None,  # [b, n] bool padding mask
    ) -> torch.Tensor:
        """Backbone forward -> [b, n, mel] float32 flow prediction."""
        dtype = self.compute_dtype
        x = self.input_embed(x.to(dtype), cond.to(dtype), text_embed, drop_audio_cond=drop_audio_cond)
        raw = rotary_freqs(x.shape[1], self.cfg.dim_head, device=x.device)
        rope = (torch.cos(raw), torch.sin(raw))  # once per forward, not per layer
        for block, mod in zip(self.transformer_blocks, time_mods["blocks"]):
            x = block(x, mod, mask=mask, rope=rope)
        x = self.norm_out(x, time_mods["final"])
        return apply_linear(self.proj_out, x).float()
