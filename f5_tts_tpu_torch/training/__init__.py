"""Training: the CFM trainer and the duration predictor's trainer."""

from f5_tts_tpu_torch.training.duration_trainer import DurationTrainer, make_duration_train_step
from f5_tts_tpu_torch.training.trainer import F5TTSTrainer, make_optimizer, make_train_step

__all__ = ["DurationTrainer", "F5TTSTrainer", "make_duration_train_step", "make_optimizer", "make_train_step"]
