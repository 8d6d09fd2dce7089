"""Model and audio configuration, a copy of the JAX package's `config.py`.

The port carries its own copy because the JAX package cannot be imported
without JAX. The field names and defaults are identical, so a `config.json`
written by either package's `save_pretrained` loads in the other.

`use_flash_attention` selects a JAX-only code path: it is kept so such
snapshots load and is not read by the port, whose attention goes to the
CUDA kernels for a CUDA tensor and to the plain PyTorch versions for a CPU
tensor. `int8_compute` samples with W8A8 int8 compute in both packages:
the DiT blocks' attention and feed-forward linears run int8 weights and
per-token int8 activations (`models/quant.py` `w8a8_blocks_`); training
ignores it. `remat` turns on activation checkpointing in the DiT's training
forward in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class AudioConfig:
    """Log-mel front-end parameters."""

    sample_rate: int = 24_000
    n_fft: int = 1024
    hop_length: int = 256
    n_mels: int = 100

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop_length


@dataclass(frozen=True)
class DiTConfig:
    """Diffusion-transformer backbone hyperparameters.

    Base pretrained config: dim=1024, depth=22, heads=16, ff_mult=2,
    text_dim=512, conv_layers=4.
    """

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_dim: int = 512
    text_mask_padding: bool = True
    conv_layers: int = 4
    conv_mult: int = 2
    dropout: float = 0.0
    # absolute positional table size for the text branch (~44 s of 24 kHz audio)
    max_pos: int = 4096
    # "bfloat16" for the fast path, "float32" for parity testing
    compute_dtype: str = "float32"
    # read by the JAX package only (see the module docstring)
    use_flash_attention: bool = True
    # W8A8 int8 compute when sampling (see the module docstring)
    int8_compute: bool = False
    # activation checkpointing of each block in training
    remat: bool = False

    def replace(self, **kw) -> "DiTConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DurationConfig:
    """Duration-predictor transformer."""

    dim: int = 512
    depth: int = 8
    heads: int = 8
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_dim: int = 512
    conv_layers: int = 2
    dropout: float = 0.0
    max_pos: int = 4096
    compute_dtype: str = "float32"
    # read by the JAX package only (see the module docstring)
    use_flash_attention: bool = True

    def replace(self, **kw) -> "DurationConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CFMConfig:
    """Conditional flow-matching wrapper config."""

    audio_drop_prob: float = 0.3
    cond_drop_prob: float = 0.2
    frac_lengths_mask: tuple[float, float] = (0.7, 1.0)
    max_duration: int = 4096
    # sequence-length bucket (frames); padded tails are masked out
    duration_bucket: int = 256


@dataclass(frozen=True)
class VocosConfig:
    """Vocos mel-24khz vocoder."""

    input_channels: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_length: int = 256
    compute_dtype: str = "float32"


# Pretrained "v1" base model configuration.
F5TTS_V1_BASE = DiTConfig()

# Pretrained duration model configuration.
DURATION_V2 = DurationConfig()

# The small training example's configuration (768 x 16 layers x 8 heads of 64).
F5TTS_SMALL = DiTConfig(
    dim=768,
    depth=16,
    heads=8,
    ff_mult=2,
    text_dim=384,
    conv_layers=4,
    text_num_embeds=256,
)
