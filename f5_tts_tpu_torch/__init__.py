"""F5-TTS in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package `f5_tts_tpu`, which stays the reference it is
tested against. This package imports neither JAX nor `f5_tts_tpu`.
"""

from f5_tts_tpu_torch.config import AudioConfig, CFMConfig, DiTConfig, DurationConfig, VocosConfig
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.vocos import Vocos

__all__ = ["AudioConfig", "CFMConfig", "DiTConfig", "DurationConfig", "DurationPredictor", "F5TTS", "Vocos",
           "VocosConfig"]
