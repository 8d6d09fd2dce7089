"""Training data: a directory of WAV files in LibriTTS-R layout
(`load_dir`), or a LibriTTS-R split's archive already on disk
(`load_libritts_r`, which gunzips and extracts it; the corpus download is
not ported), through the streaming pipeline (`make_training_pipeline`) into
the trainers' batches."""

from f5_tts_tpu_torch.data.libritts import load_dir, load_libritts_r, load_libritts_r_tarfile
from f5_tts_tpu_torch.data.loader import Stream, make_training_pipeline

__all__ = ["Stream", "load_dir", "load_libritts_r", "load_libritts_r_tarfile", "make_training_pipeline"]
