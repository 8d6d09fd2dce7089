"""Training data: a directory of WAV files in LibriTTS-R layout
(`load_dir`) through the streaming pipeline (`make_training_pipeline`) into
the trainers' batches. The corpus download is not ported."""

from f5_tts_tpu_torch.data.libritts import load_dir
from f5_tts_tpu_torch.data.loader import Stream, make_training_pipeline

__all__ = ["Stream", "load_dir", "make_training_pipeline"]
