"""Duration predictor trainer (the port of the JAX package's
`training/duration_trainer.py`): the CFM trainer's step factory, schedule,
optimizer, EMA, gradient accumulation and exact resume around
`duration_loss`. Checkpoints are in the published duration_v2 naming.
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path

import numpy as np
import torch

from f5_tts_tpu_torch.models.convert import (
    convert_duration_state,
    export_duration_state,
    mlx_names,
    rotary_inv_freq,
    state_numpy,
)
from f5_tts_tpu_torch.models.duration import DurationPredictor, duration_loss
from f5_tts_tpu_torch.training import checkpoints as C
from f5_tts_tpu_torch.training.trainer import (
    AdamW,
    TrainState,
    _build_step,
    batch_text,
    init_train_state,
    make_optimizer,
    split_microbatches,
    step_generator,
)
from f5_tts_tpu_torch.utils.safetensors import load_file, save_file


def make_duration_train_step(
    optimizer: AdamW,
    frames_per_second: float,
    ema_decay: float | None = None,
    grad_accum: int = 1,
):
    """The step for a TrainState over a `DurationPredictor`, with the CFM
    step's mechanics (trainer._build_step); `draws` are the prefix uniforms
    [b] (a list of k with `grad_accum=k`)."""

    def loss_fn(predictor, mel, text, lens, generator, rand_frac):
        return duration_loss(predictor, mel, text, lens, generator=generator, rand_frac=rand_frac,
                             frames_per_second=frames_per_second)

    return _build_step(loss_fn, optimizer, ema_decay, grad_accum)


class DurationTrainer:
    def __init__(
        self,
        model: DurationPredictor,
        num_warmup_steps: int = 1000,
        max_grad_norm: float = 1.0,
        log_with_wandb: bool = False,
        results_dir: str = "results",
        ema_decay: float | None = None,
        use_orbax: bool = False,
    ):
        if use_orbax:
            raise NotImplementedError(C.ORBAX_UNSUPPORTED)
        self.model = model
        self.num_warmup_steps = num_warmup_steps
        self.max_grad_norm = max_grad_norm
        self.log_with_wandb = log_with_wandb
        self.results_dir = Path(results_dir)
        self.ema_decay = ema_decay
        self.state: TrainState | None = None

    # ------------------------------------------------------------ checkpoint

    def save_checkpoint(self, step: int) -> None:
        """Weights in the published duration_v2 convention (MLX naming and
        the rotary inv_freq), the EMA weights beside them, and the optimizer
        state and step."""
        os.makedirs(self.results_dir, exist_ok=True)
        save_file(export_duration_state(self.model), self.results_dir / f"duration_{step}.safetensors")
        if self.state is not None:
            if self.state.ema is not None:
                flat = mlx_names(state_numpy(self.state.ema))
                flat["transformer.rotary_embed.inv_freq"] = rotary_inv_freq(self.model.cfg.dim_head)
                save_file(flat, self.results_dir / f"duration_{step}.ema.safetensors")
            C.save_train_state(self.state, self.results_dir / f"duration_{step}.trainstate.safetensors")

    def load_checkpoint(self, step: int) -> None:
        cfg = self.model.cfg
        flat = load_file(self.results_dir / f"duration_{step}.safetensors")
        self.model.load_state_dict(convert_duration_state(flat, cfg))
        if self.state is not None:
            ema_path = self.results_dir / f"duration_{step}.ema.safetensors"
            if self.state.ema is not None and ema_path.exists():
                for k, v in convert_duration_state(load_file(ema_path), cfg).items():
                    self.state.ema[k].copy_(v)
            C.restore_train_state_file(self.state, self.results_dir / f"duration_{step}.trainstate.safetensors",
                                       "a weights-only resume restarts the schedule")

    # ------------------------------------------------------------ training

    def train(
        self,
        train_dataset,
        learning_rate: float = 1e-4,
        weight_decay: float = 1e-2,
        total_steps: int = 100_000,
        save_every: int = 10_000,
        checkpoint: int | str | None = None,  # step number or "latest"
        log_every: int = 10,
        seed: int = 0,
        grad_accum: int = 1,
    ) -> None:
        """`train_dataset` yields dicts with "mel_spec", "mel_len" and
        "transcript" (the CFM trainer's batch schema). `grad_accum=k` splits
        each batch into k microbatches before one update."""
        if self.log_with_wandb:
            import wandb

            wandb.init(project="f5tts-duration", config=dict(learning_rate=learning_rate, total_steps=total_steps))
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

        optimizer = make_optimizer(learning_rate, weight_decay, self.num_warmup_steps, total_steps,
                                   self.max_grad_norm)
        self.state = init_train_state(self.model, optimizer, ema=self.ema_decay is not None)
        if checkpoint == "latest":
            checkpoint = C.latest_checkpoint_step(self.results_dir, "duration_")
            if checkpoint is None:
                print("No checkpoint found; starting fresh")
        start_step = 0
        if checkpoint is not None:
            self.load_checkpoint(checkpoint)
            start_step = checkpoint
            print(f"Starting training at step {start_step}")

        fps = self.model.audio_cfg.frames_per_second
        step_fn = make_duration_train_step(optimizer, fps, self.ema_decay, grad_accum)
        device = self.model.device
        global_step = start_step
        start_date = datetime.datetime.now()
        try:
            for batch in train_dataset:
                mel = torch.as_tensor(np.asarray(batch["mel_spec"], np.float32), device=device)
                if mel.ndim == 4:
                    mel = mel[:, 0]
                lens = torch.as_tensor(np.asarray(batch["mel_len"], np.int32).reshape(-1), device=device)
                text = batch_text(batch, None, device)
                mel, text, lens = split_microbatches(grad_accum, mel, text, lens)

                loss = step_fn(self.state, mel, text, lens, step_generator(device, seed, global_step))
                global_step += 1
                if global_step % log_every == 0 or global_step == start_step + 1:
                    loss_val = float(loss)
                    if self.log_with_wandb:
                        import wandb

                        wandb.log({"loss": loss_val}, step=global_step)
                    print(f"step {global_step}/{total_steps}: loss {loss_val:.4f}")
                if global_step % save_every == 0:
                    self.save_checkpoint(global_step)
                if global_step >= total_steps:
                    break
        finally:
            if self.log_with_wandb:
                import wandb

                wandb.finish()
        print(f"Training complete in {datetime.datetime.now() - start_date}")
