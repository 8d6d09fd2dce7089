"""Vocos mel-spectrogram vocoder (the port of the JAX package's
`models/vocos.py`): a ConvNeXt (v1) backbone and an ISTFT head with the
`charactr/vocos-mel-24khz` architecture. Parameter names are those of the
published checkpoint.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from f5_tts_tpu_torch.audio.istft import istft
from f5_tts_tpu_torch.audio.mel import hanning
from f5_tts_tpu_torch.config import VocosConfig
from f5_tts_tpu_torch.models.blocks import LayerNorm
from f5_tts_tpu_torch.utils.modules import conv1d, gelu, init_parameters_, linear


class VocosConvNeXtBlock(nn.Module):
    """ConvNeXt v1 block with layer scale (no GRN)."""

    def __init__(self, dim: int, intermediate_dim: int, layer_scale: float):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = conv1d(x, self.dwconv.weight, self.dwconv.bias, groups=x.shape[-1], padding=3)
        x = self.norm(x)
        x = gelu(linear(x, self.pwconv1.weight, self.pwconv1.bias), approximate=False)
        x = linear(x, self.pwconv2.weight, self.pwconv2.bias)
        return residual + self.gamma.to(x.dtype) * x


class VocosBackbone(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.embed = nn.Conv1d(cfg.input_channels, cfg.dim, 7)
        self.norm = LayerNorm(cfg.dim)
        self.convnext = nn.ModuleList(
            VocosConvNeXtBlock(cfg.dim, cfg.intermediate_dim, 1.0 / cfg.num_layers)
            for _ in range(cfg.num_layers)
        )
        self.final_layer_norm = LayerNorm(cfg.dim)


class VocosHead(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.out = nn.Linear(cfg.dim, cfg.n_fft + 2)


class Vocos(nn.Module):
    def __init__(self, cfg: VocosConfig = VocosConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = VocosBackbone(cfg)
        self.head = VocosHead(cfg)

    @classmethod
    def init(
        cls, generator: torch.Generator, cfg: VocosConfig = VocosConfig(), device: torch.device | str = "cuda"
    ) -> "Vocos":
        """Random weights drawn from `generator`, which must live on `device`."""
        with torch.device(device):
            vocos = cls(cfg)
        init_parameters_(vocos, generator)
        return vocos

    @classmethod
    def from_pretrained(cls, local_dir: str | Path, cfg: VocosConfig | None = None,
                        device: torch.device | str = "cuda") -> "Vocos":
        """Load a local vocoder directory (models/convert.py
        `load_vocos_pretrained`: model.safetensors, pytorch_model.bin or
        weights.safetensors, tried in that order)."""
        from f5_tts_tpu_torch.models.convert import load_vocos_pretrained

        return load_vocos_pretrained(local_dir, cfg, device)

    def decode(self, mel: torch.Tensor, valid_frames: int | None = None) -> torch.Tensor:
        """mel [b, n, n_mels] -> waveform [b, (n - 1) * hop_length].

        With `valid_frames`, a mel whose frames past it are zero decodes, over
        the first (valid_frames - 1) * hop samples, exactly as
        mel[:, :valid_frames] would: positions past it are re-zeroed after the
        first LayerNorm and after every block (only the dwconvs mix positions,
        and they must see the zeros their padding would give), and the ISTFT
        drops those frames from the overlap-add and the envelope."""
        cfg = self.cfg
        bb = self.backbone
        x = mel.to(getattr(torch, cfg.compute_dtype))
        vmask = None
        if valid_frames is not None:
            vmask = (torch.arange(x.shape[1], device=x.device) < valid_frames)[None, :, None].to(x.dtype)

        x = conv1d(x, bb.embed.weight, bb.embed.bias, padding=3)
        x = bb.norm(x)
        if vmask is not None:
            x = x * vmask
        for block in bb.convnext:
            x = block(x)
            if vmask is not None:
                x = x * vmask
        x = bb.final_layer_norm(x)

        x = linear(x, self.head.out.weight, self.head.out.bias).float()  # [b, n, n_fft + 2]
        mag, phase = x.chunk(2, dim=-1)
        mag = torch.clamp(torch.exp(mag), max=1e2)
        spec = torch.polar(mag, phase)
        window = torch.as_tensor(hanning(cfg.n_fft), device=x.device)
        return istft(spec, window, cfg.n_fft, cfg.hop_length, valid_frames=valid_frames)
