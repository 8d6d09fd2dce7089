"""F5-TTS in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package `f5_tts_tpu`, which stays the reference it is
tested against. This package imports neither JAX nor `f5_tts_tpu`.
"""

import importlib

from f5_tts_tpu_torch.config import AudioConfig, CFMConfig, DiTConfig, DurationConfig, UNetTConfig, VocosConfig

# the model classes load on first use, so that an artifact server (artifact_serve.py), which runs exported
# programs, imports no model code
_MODELS = {"F5TTS": "f5_tts_tpu_torch.models.cfm", "DurationPredictor": "f5_tts_tpu_torch.models.duration",
           "Vocos": "f5_tts_tpu_torch.models.vocos", "UNetT": "f5_tts_tpu_torch.models.unett"}


def __getattr__(name: str):
    if name in _MODELS:
        return getattr(importlib.import_module(_MODELS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = ["AudioConfig", "CFMConfig", "DiTConfig", "DurationConfig", "DurationPredictor", "F5TTS", "UNetT",
           "UNetTConfig", "Vocos", "VocosConfig"]
