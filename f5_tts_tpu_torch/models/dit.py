"""Diffusion Transformer backbone (the port of the JAX package's `models/dit.py`).

The JAX functions map to methods of `DiT`:
  - `dit_text_embed`          -> `DiT.embed_text`
  - `dit_time_mods`           -> `DiT.time_mods`
  - `dit_forward_precomputed` -> `DiT.forward` (sampling: precomputed text
    embedding and time modulations)
  - `dit_forward`             -> `DiT.forward_train` (training: text ids and
    per-sample times in, optional dropout and activation checkpointing)
The depth dimension is a ModuleList walked in Python; the output is float32.
Under a mesh (parallel/mesh.py) the sampler and the sharded train step run
a `DiTGroup`: one DiT shard a slot of a data row's tensor-parallel group
(and, in training, of each of its seq slots), run block by block in step.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from f5_tts_tpu_torch.config import DiTConfig
from f5_tts_tpu_torch.models import blocks as B
from f5_tts_tpu_torch.models.rope import rotary_freqs
from f5_tts_tpu_torch.parallel.mesh import group_frames, lockstep
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
        return B.run_local(self.steps(x, cond, text_embed, time_mods, drop_audio_cond, mask))

    def steps(self, x, cond, text_embed, time_mods: dict, drop_audio_cond=False, mask=None):
        """`forward` as a generator: it yields where its blocks do (a shard
        of a tensor-parallel group, `DiTGroup`)."""
        dtype = self.compute_dtype
        x = self.input_embed(x.to(dtype), cond.to(dtype), text_embed, drop_audio_cond=drop_audio_cond)
        raw = rotary_freqs(x.shape[1], self.cfg.dim_head, device=x.device)
        rope = (torch.cos(raw), torch.sin(raw))  # once per forward, not per layer
        for block, mod in zip(self.transformer_blocks, time_mods["blocks"]):
            x = yield from block.steps(x, mod, mask=mask, rope=rope)
        x = self.norm_out(x, time_mods["final"])
        return apply_linear(self.proj_out, x).float()

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
        """Full backbone forward -> [b, n, mel] float32. Each sample's time
        goes through the time embedding and every block's AdaLN-Zero
        modulation ([b, 6 * dim]). Dropout runs when a generator is given
        and cfg.dropout > 0, with one seed per layer. With cfg.remat each
        block is recomputed in the backward instead of keeping its
        activations (torch.utils.checkpoint)."""
        h, t_emb, rope = self.train_inputs(x, cond, text, time, drop_audio_cond, drop_text)
        rate = self.cfg.dropout
        use_dropout = generator is not None and rate > 0.0
        seeds = B.draw_seeds(generator, self.cfg.depth) if use_dropout else [None] * self.cfg.depth

        def run_block(block, h, seed):
            return block(h, block.attn_norm.mods(t_emb), mask=mask, rope=rope, dropout_rate=rate, dropout_seed=seed)

        for block, seed in zip(self.transformer_blocks, seeds):
            if self.cfg.remat:
                h = checkpoint(run_block, block, h, seed, use_reentrant=False)
            else:
                h = run_block(block, h, seed)
        return self.train_head(h, t_emb)

    def train_inputs(self, x, cond, text, time, drop_audio_cond=False, drop_text=False, frames=None) -> tuple:
        """The training forward up to the first block: (the blocks' input
        [b, n, dim], the time embedding [b, dim], RoPE's (cos, sin)). With
        `frames` (a seq slot, parallel/mesh.py `Frames`) x and cond are the
        whole sequence's and the blocks' input is the slot's frames: the
        text embedding runs whole (its GRN sums over every frame), the input
        embedding on the window its convolutions reach (`blocks.embed_frames`);
        the tables stay the whole sequence's."""
        dtype = self.compute_dtype
        b, n = x.shape[0], x.shape[1]
        time = torch.as_tensor(time, dtype=torch.float32, device=x.device)
        if time.ndim == 0:
            time = time.expand(b)
        t_emb = self.time_embed(time, dtype)  # [b, dim]
        text_embed = self.embed_text(text, n, drop_text=drop_text)
        h = B.embed_frames(self.input_embed, frames, x.to(dtype), cond.to(dtype), text_embed,
                           drop_audio_cond=drop_audio_cond)
        raw = rotary_freqs(n, self.cfg.dim_head, device=x.device)
        return h, t_emb, (torch.cos(raw), torch.sin(raw))

    def train_head(self, h: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        """The training forward after the last block -> [b, n, mel] float32."""
        h = self.norm_out(h, self.norm_out.mods(t_emb))
        return apply_linear(self.proj_out, h).float()


def _on(value, device: torch.device):
    """A forward argument on `device`: tensors copied (the same tensor where
    it is there already), dicts of them entry by entry, anything else as is."""
    if isinstance(value, torch.Tensor):
        return value.to(device, non_blocking=True)
    if isinstance(value, dict):
        return {k: _on(v, device) for k, v in value.items()}
    return value


def require_dit(model, user: str) -> None:
    """ValueError unless `model` is a DiT: `user` (sampling, serving,
    export, quantization, a grid) is built on the DiT's blocks."""
    if not isinstance(model, DiT):
        raise ValueError(f"{user} takes the DiT, not a {type(model).__name__}")


class DiTGroup:
    """One data row's DiT, split over its tensor-parallel group
    (models/shard.py `shard_model_for_inference`, or trainable shards from
    `shard_model_for_training` for `forward_train`): one shard a slot, each
    on its slot's device, with heads / model heads and hidden / model
    feed-forward units. The sampler calls it as it calls a DiT. The text
    embedding and the time modulations are replicated work, computed once on
    the first slot; a forward copies its inputs to every slot and runs each
    block across the group in step (`mesh.lockstep`): each slot's partial,
    then the reduction, then the next block. Every slot computes the
    replicated layers itself, as GSPMD does, and the first slot's output is
    returned. A group of one shard is that shard's plain forward.

    In training, `seq` above 1 (sequence parallelism): the shards are
    row-major over (seq, model) slots, each seq slot a copy of the model
    group that computes its frames of the sequence (parallel/mesh.py
    `Frames`), and `forward_train` returns one output a seq slot."""

    def __init__(self, shards: list[DiT], seq: int = 1):
        require_dit(shards[0], "DiTGroup (a tensor-parallel or sequence-parallel grid)")
        self.shards = list(shards)
        self.seq = seq
        self.cfg = self.shards[0].cfg
        self.devices = [next(s.parameters()).device for s in self.shards]

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.shards[0].compute_dtype

    def embed_text(self, text: torch.Tensor, seq_len: int, drop_text=False) -> torch.Tensor:
        return self.shards[0].embed_text(text, seq_len, drop_text)

    def time_mods(self, times: torch.Tensor) -> dict:
        return self.shards[0].time_mods(times)

    def __call__(self, x, cond, text_embed, time_mods: dict, drop_audio_cond=False, mask=None) -> torch.Tensor:
        args = (x, cond, text_embed, time_mods, drop_audio_cond, mask)
        if len(self.shards) == 1:
            return self.shards[0](*args)
        steps = [shard.steps(*(_on(a, dev) for a in args)) for shard, dev in zip(self.shards, self.devices)]
        return lockstep(steps)[0]

    def forward_train(self, x, cond, text, time, drop_audio_cond=False, drop_text=False, mask=None, seeds=None,
                      rows=None):
        """`DiT.forward_train` over the group (trainable shards, models/shard.py
        `shard_model_for_training`): every slot computes the replicated
        layers from its own leaves, the blocks run in step with their
        row-parallel sums (and seq gathers) recorded by autograd, and the
        first slot's output is returned; with `seq` above 1, a list of each
        seq slot's first slot's output over its frames, in seq order. `seeds`
        are the layers' dropout seeds, drawn once for the global batch;
        `rows` place this data row in it. With cfg.remat each block of the
        whole group is one checkpointed function: the backward recomputes
        every slot's block, the forward's reductions and gathers included
        (one more counted sum a row-parallel linear, one more gather an
        attention), then runs the block's backward with its own."""
        cfg = self.cfg
        args = (x, cond, text, time, drop_audio_cond, drop_text)
        frames = group_frames(self.seq, len(self.shards), x.shape[1])
        prepared = [shard.train_inputs(*(_on(a, dev) for a in args), frames=f)
                    for shard, dev, f in zip(self.shards, self.devices, frames)]
        hs = tuple(h for h, _, _ in prepared)
        masks = [None if mask is None else mask.to(dev) for dev in self.devices]
        seeds = [None] * cfg.depth if seeds is None else seeds

        for i, seed in enumerate(seeds):
            def run_group_block(*hs, i=i, seed=seed):
                steps = [shard.transformer_blocks[i].steps(
                    h, shard.transformer_blocks[i].attn_norm.mods(t_emb), mask=m, rope=rope,
                    dropout_rate=cfg.dropout, dropout_seed=seed, rows=rows, frames=f)
                    for shard, h, (_, t_emb, rope), m, f in zip(self.shards, hs, prepared, masks, frames)]
                return tuple(lockstep(steps, self.seq))

            hs = checkpoint(run_group_block, *hs, use_reentrant=False) if cfg.remat else run_group_block(*hs)
        heads = [self.shards[s].train_head(hs[s], prepared[s][1])
                 for s in range(0, len(self.shards), len(self.shards) // self.seq)]
        return heads if self.seq > 1 else heads[0]
