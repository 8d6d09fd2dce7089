"""Audio front-end: the log-mel spectrogram (`mel`), the ISTFT (`istft`),
WAV I/O (`io`) and host resampling of prompt audio (`resample`)."""

from f5_tts_tpu_torch.audio.mel import MelSpec, hanning, log_mel_spectrogram, mel_filters, stft
from f5_tts_tpu_torch.audio.resample import resample

__all__ = ["MelSpec", "hanning", "log_mel_spectrogram", "mel_filters", "resample", "stft"]
