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
from f5_tts_tpu_torch.models.duration import DurationPredictor, duration_loss, duration_prefix
from f5_tts_tpu_torch.models.shard import shard_train_state
from f5_tts_tpu_torch.parallel import distributed as D
from f5_tts_tpu_torch.parallel.mesh import ShardedTrainState, refuse_stage, shard_train_step
from f5_tts_tpu_torch.training import checkpoints as C
from f5_tts_tpu_torch.training.trainer import (
    AdamW,
    TrainState,
    _build_step,
    batch_text,
    dropout_seeds,
    gathered_train_state,
    init_train_state,
    make_optimizer,
    split_microbatches,
    step_generator,
    training_grid,
)
from f5_tts_tpu_torch.utils.safetensors import load_file, save_file


class DurationObjective:
    """The duration loss as both steps take it (see trainer.py
    `CFMObjective`): the sharded step draws the global batch's prefix
    uniforms and seeds, and sums each data row's absolute errors over the
    global batch size."""

    def __init__(self, frames_per_second: float):
        self.frames_per_second = frames_per_second

    @staticmethod
    def prepare(inp: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        return inp

    def loss(self, predictor, mel, text, lens, generator, rand_frac) -> torch.Tensor:
        return duration_loss(predictor, mel, text, lens, generator=generator, rand_frac=rand_frac,
                             frames_per_second=self.frames_per_second)

    @staticmethod
    def draw(generator: torch.Generator, batch: int, mel: torch.Tensor) -> torch.Tensor:
        return torch.rand(batch, generator=generator, device=generator.device).to(mel.device)

    @staticmethod
    def take(rand_frac: torch.Tensor, sl: slice, device=None) -> torch.Tensor:
        return rand_frac[sl] if device is None else rand_frac[sl].to(device, non_blocking=True)

    seeds = staticmethod(dropout_seeds)

    @staticmethod
    def count(mel: torch.Tensor, lens: torch.Tensor, rand_frac: torch.Tensor) -> torch.Tensor:
        return torch.tensor(float(mel.shape[0]), device=mel.device)

    def numerator(self, group, mel, text, lens, rand_frac, seeds, rows) -> torch.Tensor:
        x, mask = duration_prefix(mel, lens, rand_frac)
        pred = group.head(group.transformer(x, text, seeds, rows), mask)
        return (pred - lens.float() / self.frames_per_second).abs().sum()


def make_duration_train_step(
    optimizer: AdamW,
    frames_per_second: float,
    ema_decay: float | None = None,
    grad_accum: int = 1,
):
    """The step for a TrainState over a `DurationPredictor`, with the CFM
    step's mechanics (trainer._build_step); `draws` are the prefix uniforms
    [b] (a list of k with `grad_accum=k`)."""
    return _build_step(DurationObjective(frames_per_second), optimizer, ema_decay, grad_accum)


class DurationTrainer:
    """The duration predictor's training loop and checkpoints; `mesh`
    (data, seq and model), `fsdp` and `use_orbax` as in `F5TTSTrainer`."""

    def __init__(
        self,
        model: DurationPredictor,
        num_warmup_steps: int = 1000,
        max_grad_norm: float = 1.0,
        log_with_wandb: bool = False,
        results_dir: str = "results",
        ema_decay: float | None = None,
        use_orbax: bool = False,
        mesh=None,
        fsdp: bool = False,
    ):
        if mesh is not None:
            refuse_stage(mesh, "DurationTrainer(mesh=)")
        self.model = model
        self.num_warmup_steps = num_warmup_steps
        self.max_grad_norm = max_grad_norm
        self.log_with_wandb = log_with_wandb
        self.results_dir = Path(results_dir)
        self.ema_decay = ema_decay
        self.use_orbax = use_orbax
        self.mesh = mesh
        self.fsdp = fsdp
        self.ckpt_mgr: C.TrainCheckpointManager | None = None
        self.state: TrainState | ShardedTrainState | None = None
        self.last_loss: torch.Tensor | None = None

    # ------------------------------------------------------------ checkpoint

    def save_checkpoint(self, step: int) -> None:
        """Weights in the published duration_v2 convention (MLX naming and
        the rotary inv_freq), the EMA weights beside them, and the optimizer
        state and step (in the checkpoint manager with `use_orbax`). A
        sharded state is gathered for the files; process 0 alone writes
        them."""
        os.makedirs(self.results_dir, exist_ok=True)
        state = None if self.state is None else gathered_train_state(self.state, self.model)
        writer = D.process_index() == 0
        if writer:
            save_file(export_duration_state(self.model), self.results_dir / f"duration_{step}.safetensors")
        if state is not None:
            if state.ema is not None and writer:
                flat = mlx_names(state_numpy(state.ema))
                flat["transformer.rotary_embed.inv_freq"] = rotary_inv_freq(self.model.cfg.dim_head)
                save_file(flat, self.results_dir / f"duration_{step}.ema.safetensors")
            if self.ckpt_mgr is not None:
                self.ckpt_mgr.save(step, self.state)
            elif writer:
                C.save_train_state(state, self.results_dir / f"duration_{step}.trainstate.safetensors")

    def load_checkpoint(self, step: int) -> None:
        cfg = self.model.cfg
        flat = load_file(self.results_dir / f"duration_{step}.safetensors")
        state = None if self.state is None else gathered_train_state(self.state, self.model)
        self.model.load_state_dict(convert_duration_state(flat, cfg))
        if state is not None:
            ema_path = self.results_dir / f"duration_{step}.ema.safetensors"
            if state.ema is not None and ema_path.exists():
                for k, v in convert_duration_state(load_file(ema_path), cfg).items():
                    state.ema[k].copy_(v)
            C.restore_train_state_file(state, self.results_dir / f"duration_{step}.trainstate.safetensors",
                                       "a weights-only resume restarts the schedule")
            if not isinstance(self.state, TrainState):
                self.state = shard_train_state(state, self.state.mesh, self.state.fsdp)

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
        if self.use_orbax:
            self.ckpt_mgr = C.TrainCheckpointManager(self.results_dir / "checkpoints")
        start_step = C.resume(self, checkpoint, "duration_")

        fps = self.model.audio_cfg.frames_per_second
        step_fn = make_duration_train_step(optimizer, fps, self.ema_decay, grad_accum)
        device, data_size = self.model.device, None
        mesh = training_grid(self.mesh, device)
        if mesh is not None:
            self.state = shard_train_state(self.state, mesh, fsdp=self.fsdp)
            step_fn = shard_train_step(step_fn, mesh, self.state, grad_accum=grad_accum, fsdp=self.fsdp)
            device, data_size = self.state.slots[0].device, mesh.shape["data"]
        global_step = start_step
        start_date = datetime.datetime.now()
        try:
            for batch in train_dataset:
                mel = torch.as_tensor(np.asarray(batch["mel_spec"], np.float32), device=device)
                if mel.ndim == 4:
                    mel = mel[:, 0]
                lens = torch.as_tensor(np.asarray(batch["mel_len"], np.int32).reshape(-1), device=device)
                text = batch_text(batch, None, device)
                mel, text, lens = split_microbatches(grad_accum, mel, text, lens, data_size=data_size)

                loss = step_fn(self.state, mel, text, lens, step_generator(device, seed, global_step))
                self.last_loss = loss
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
            gathered_train_state(self.state, self.model)  # the caller's model holds the trained weights
            if self.ckpt_mgr is not None:
                self.ckpt_mgr.wait()
            if self.log_with_wandb:
                import wandb

                wandb.finish()
        print(f"Training complete in {datetime.datetime.now() - start_date}")
