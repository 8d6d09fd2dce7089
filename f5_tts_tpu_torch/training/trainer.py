"""CFM trainer (the port of the JAX package's `training/trainer.py`): AdamW
with a warm-up then cosine schedule and optax's global-norm clip, an
optional EMA of the weights, gradient accumulation, checkpoints with exact
resume, and periodic sampling.

The JAX step is a pure function of a state pytree; here `TrainState` holds
the model itself (its float32 parameters are the master weights, updated in
place), the optimizer state keyed by parameter name, the update count and
the EMA copy. A step runs the forward in the model's compute dtype and the
backward through the attention kernels (ops/flash_attention.py), then clip,
AdamW and EMA as foreach operations on the float32 parameters. Randomness
comes from an explicit `torch.Generator`: one per step, seeded from the run's
seed and the step number, so a resumed run draws what an uninterrupted one
would.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import math
import os
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram
from f5_tts_tpu_torch.config import AudioConfig, CFMConfig
from f5_tts_tpu_torch.models.cfm import F5TTS, cfm_loss
from f5_tts_tpu_torch.models.convert import (
    convert_dit_state,
    export_mlx_state,
    mlx_names,
    state_numpy,
    to_mlx_model_naming,
)
from f5_tts_tpu_torch.training import checkpoints as C
from f5_tts_tpu_torch.utils.safetensors import load_file, save_file

# RMS floor for probe-sample reference audio
TARGET_RMS = 0.1


def make_lr_schedule(
    learning_rate: float = 1e-4,
    num_warmup_steps: int = 1000,
    total_steps: int = 1_000_000,
) -> Callable[[int], float]:
    """The learning rate at update count `count` (the count before the
    update, so update 0 uses 1e-8): linear from 1e-8 to `learning_rate` over
    the warm-up, then cosine decay to 0 over the remaining steps. The values
    of optax's join_schedules([linear_schedule(1e-8, lr, warmup),
    cosine_decay_schedule(lr, max(total - warmup, 1))], [warmup]), computed
    in float32 with optax's formulas (so update 0 gives 1e-8 as float32
    cancellation leaves it, 1.0012e-8 at lr 1e-3)."""
    f32 = np.float32
    decay_steps = max(total_steps - num_warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < num_warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), num_warmup_steps)) / f32(num_warmup_steps)
            return float(f32(1e-8 - learning_rate) * frac + f32(learning_rate))
        c = f32(min(count - num_warmup_steps, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps)))
        return float(f32(learning_rate) * cosine)

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1,
    b2, eps, weight_decay)) on a dict of float32 parameters: weight decay on
    every parameter, and optax's clip rule, g * max / |g| when the global
    norm |g| >= max and g unchanged otherwise (clip_grad_norm_ would divide
    by |g| + 1e-6)."""

    schedule: Callable[[int], float]
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    # optax.adamw's defaults
    b1 = 0.9
    b2 = 0.999
    eps = 1e-8

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        """{"mu": {name: zeros}, "nu": {name: zeros}, "count": 0}."""
        return {
            "mu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "count": 0,
        }

    @torch.no_grad()
    def update_(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], opt_state: dict) -> None:
        """One update of `params` and `opt_state`, in place."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [opt_state["mu"][k] for k in names]
        nu = [opt_state["nu"][k] for k in names]
        if self.max_grad_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            factor = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
            g = torch._foreach_mul(g, factor)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = opt_state["count"]
        lr = self.schedule(count)
        count += 1
        update = torch._foreach_div(mu, 1.0 - self.b1**count)
        denom = torch._foreach_div(nu, 1.0 - self.b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, p, alpha=self.weight_decay)
        torch._foreach_add_(p, update, alpha=-lr)
        opt_state["count"] = count


def make_optimizer(
    learning_rate: float = 1e-4,
    weight_decay: float = 1e-2,
    num_warmup_steps: int = 1000,
    total_steps: int = 1_000_000,
    max_grad_norm: float = 1.0,
) -> AdamW:
    """Linear warm-up (1e-8 -> lr) then cosine decay, AdamW, global-norm clip
    (none when max_grad_norm <= 0)."""
    return AdamW(make_lr_schedule(learning_rate, num_warmup_steps, total_steps), weight_decay, max_grad_norm)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the float32 master weights), the
    optimizer state keyed by parameter name, the number of updates, and the
    EMA of the parameters when tracked."""

    model: nn.Module
    opt_state: dict
    step: int = 0
    ema: dict[str, torch.Tensor] | None = None

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def init_train_state(model: nn.Module, optimizer: AdamW, ema: bool = False) -> TrainState:
    params = dict(model.named_parameters())
    return TrainState(
        model, optimizer.init(params), 0,
        {k: p.detach().clone() for k, p in params.items()} if ema else None,
    )


def _grads(loss: torch.Tensor, params: list[torch.Tensor]) -> list[torch.Tensor]:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]


def _build_step(loss_fn, optimizer: AdamW, ema_decay: float | None, grad_accum: int):
    """The train step shared by both trainers, around `loss_fn(model, inp,
    text, lens, generator, draws) -> scalar`. The step is `(state, inp, text,
    lens, generator=None, draws=None) -> loss` and updates `state` in place.

    grad_accum == 1: one forward and backward, clip and AdamW, then the
    optional EMA e <- d e + (1 - d) p on the updated parameters.

    grad_accum == k > 1: inputs carry a leading microbatch axis [k, b, ...]
    (and `draws`, when given, is a list of k); k forward and backward passes,
    each drawing its own randomness from the generator, a float32 gradient
    sum divided by k, and one update. The loss is the microbatches' mean."""
    k = int(grad_accum)

    def train_step(state: TrainState, inp, text, lens, generator=None, draws=None) -> torch.Tensor:
        params = state.params
        tensors = list(params.values())
        if k <= 1:
            loss = loss_fn(state.model, inp, text, lens, generator, draws)
            grads = _grads(loss, tensors)
            loss = loss.detach().float()
        else:
            grads, loss = None, 0.0
            for i in range(k):
                loss_i = loss_fn(state.model, inp[i], text[i], lens[i], generator,
                                 None if draws is None else draws[i])
                g_i = _grads(loss_i, tensors)
                if grads is None:
                    grads = [g.float() for g in g_i]
                else:
                    torch._foreach_add_(grads, [g.float() for g in g_i])
                loss = loss + loss_i.detach().float()
            torch._foreach_div_(grads, float(k))
            grads = [g.to(p.dtype) for g, p in zip(grads, tensors)]
            loss = loss / k
        optimizer.update_(params, dict(zip(params, grads)), state.opt_state)
        state.step += 1
        if ema_decay is not None:
            with torch.no_grad():
                ema = [state.ema[name] for name in params]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, tensors, alpha=1.0 - ema_decay)
        return loss

    return train_step


def make_train_step(cfm_cfg: CFMConfig, optimizer: AdamW, ema_decay: float | None = None, grad_accum: int = 1):
    """The step on mel batches [b, n, d] (or [k, b, n, d] with
    `grad_accum=k`), for a TrainState over the DiT; see `_build_step`."""

    def loss_fn(dit, mel, text, lens, generator, draws):
        return cfm_loss(dit, cfm_cfg, mel, text, lens, generator=generator, draws=draws)

    return _build_step(loss_fn, optimizer, ema_decay, grad_accum)


def make_train_step_from_audio(
    cfm_cfg: CFMConfig,
    optimizer: AdamW,
    ema_decay: float | None = None,
    audio_cfg: AudioConfig | None = None,
    grad_accum: int = 1,
):
    """The step on raw audio [b, n_samples], zero-padded to whole frames:
    the log-mel runs on the audio's device inside the step, and frames past
    each length are re-zeroed, so it matches the mel step fed the host mel
    (the training forward has no attention mask, so the padding value
    counts)."""
    acfg = audio_cfg or AudioConfig()

    def loss_fn(dit, audio, text, lens, generator, draws):
        mel = log_mel_spectrogram(audio, acfg.sample_rate, acfg.n_mels, acfg.n_fft, acfg.hop_length)
        frames = torch.arange(mel.shape[1], device=mel.device)[None, :]
        mel = torch.where((frames < lens[:, None])[..., None], mel, torch.zeros_like(mel))
        return cfm_loss(dit, cfm_cfg, mel, text, lens, generator=generator, draws=draws)

    return _build_step(loss_fn, optimizer, ema_decay, grad_accum)


def split_microbatches(grad_accum: int, *arrays):
    """Reshape per-batch arrays [b, ...] into [grad_accum, b // grad_accum,
    ...] for an accumulated step; unchanged when grad_accum == 1. Raises
    ValueError when the batch does not divide."""
    b = arrays[0].shape[0]
    if b % grad_accum:
        raise ValueError(f"batch size {b} is not divisible by grad_accum={grad_accum}")
    if grad_accum <= 1:
        return arrays
    return tuple(a.reshape(grad_accum, b // grad_accum, *a.shape[1:]) for a in arrays)


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The generator of one training step, from the run's seed and the step
    number."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def batch_text(batch: dict, seq_len: int | None, device: torch.device) -> torch.Tensor:
    """The batch's transcript ids [b, nt] (padded with -1), padded or cut to
    `seq_len` when given."""
    text = np.asarray(batch["transcript"])
    if text.ndim == 3:
        text = text[:, :, 0] if text.shape[-1] == 1 else text[:, 0]
    if seq_len is not None:
        if text.shape[-1] < seq_len:
            text = np.pad(text, ((0, 0), (0, seq_len - text.shape[-1])), constant_values=-1)
        text = text[:, :seq_len]
    return torch.as_tensor(text.astype(np.int32), device=device)


class F5TTSTrainer:
    """Training loop, checkpoints and probe samples for an `F5TTS` model's DiT."""

    def __init__(
        self,
        model: F5TTS,
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
        """Weights in full-model MLX naming ("transformer." prefix and the
        rotary inv_freq), which the reference and the JAX package's
        `convert_dit_state` load; the EMA weights beside them; and the
        optimizer state and step for an exact resume."""
        os.makedirs(self.results_dir, exist_ok=True)
        dim_head = self.model.dit_cfg.dim_head
        save_file(to_mlx_model_naming(export_mlx_state(self.model.dit), dim_head),
                  self.results_dir / f"f5tts_{step}.safetensors")
        if self.state is not None:
            if self.state.ema is not None:
                save_file(to_mlx_model_naming(mlx_names(state_numpy(self.state.ema)), dim_head),
                          self.results_dir / f"f5tts_{step}.ema.safetensors")
            C.save_train_state(self.state, self.results_dir / f"f5tts_{step}.trainstate.safetensors")

    def load_checkpoint(self, step: int) -> None:
        cfg = self.model.dit_cfg
        flat = load_file(self.results_dir / f"f5tts_{step}.safetensors")
        self.model.dit.load_state_dict(convert_dit_state(flat, cfg))
        if self.state is not None:
            ema_path = self.results_dir / f"f5tts_{step}.ema.safetensors"
            if self.state.ema is not None and ema_path.exists():
                for k, v in convert_dit_state(load_file(ema_path), cfg).items():
                    self.state.ema[k].copy_(v)
            C.restore_train_state_file(self.state, self.results_dir / f"f5tts_{step}.trainstate.safetensors",
                                       "a weights-only resume restarts the schedule")

    # ------------------------------------------------------------ sampling

    def generate_sample(
        self,
        sample_audio: str,
        sample_ref_text: str,
        sample_generation_text: str,
        sample_generation_duration: float,
        step: int,
        samples_dir: str = "samples",
    ) -> None:
        """Synthesize a probe utterance with the EMA weights when tracked;
        save the wave (with a vocoder) and the mel trajectory as a GIF (when
        matplotlib and PIL are installed)."""
        from f5_tts_tpu_torch.audio.io import read_wav, write_wav

        acfg = self.model.audio_cfg
        audio, _ = read_wav(sample_audio)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        ref_audio_duration = audio.shape[0] / acfg.sample_rate
        rms = float(np.sqrt(np.mean(np.square(audio))))
        if rms < TARGET_RMS:
            audio = audio * TARGET_RMS / rms

        model = self.model
        if self.state is not None and self.state.ema is not None:
            dit = copy.deepcopy(model.dit)
            dit.load_state_dict(self.state.ema)
            model = F5TTS(dit, model.dit_cfg, model.cfm_cfg, model.audio_cfg, model.vocab_char_map,
                          model.vocoder, model.duration_predictor)
        start = datetime.datetime.now()
        wave, trajectories = model.sample(
            audio[None, :],
            [sample_ref_text + " " + sample_generation_text],
            duration=int((ref_audio_duration + sample_generation_duration) * acfg.frames_per_second),
            method="rk4", steps=8, cfg_strength=2.0, speed=1, sway_sampling_coef=-1.0,
        )
        print(f"Generated sample at step {step} in {(datetime.datetime.now() - start).total_seconds():0.1f}s")

        os.makedirs(f"{samples_dir}/audio", exist_ok=True)
        if model.vocoder is not None:
            write_wav(f"{samples_dir}/audio/step_{step}.wav", wave.cpu().numpy()[audio.shape[0]:], acfg.sample_rate)
        self._save_trajectory_gif(trajectories.cpu().numpy(), audio.shape[0] // acfg.hop_length, step, samples_dir)

    def _save_trajectory_gif(self, trajectories: np.ndarray, ref_frames: int, step: int, samples_dir: str) -> None:
        try:
            import io

            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            from PIL import Image
        except ImportError:
            return

        frames = []
        for traj in trajectories:
            plt.figure(figsize=(10, 4))
            plt.imshow(traj[0, ref_frames:].T, aspect="auto", origin="lower", interpolation="none")
            plt.yticks([])
            buf = io.BytesIO()
            plt.savefig(buf, format="png")
            buf.seek(0)
            frames.append(Image.open(buf))
            plt.close()
        os.makedirs(f"{samples_dir}/viz", exist_ok=True)
        frames[0].save(f"{samples_dir}/viz/step_{step}.gif", save_all=True, append_images=frames[1:],
                       duration=300, loop=0)

    # ------------------------------------------------------------ training

    def train(
        self,
        train_dataset,
        learning_rate: float = 1e-4,
        weight_decay: float = 1e-2,
        total_steps: int = 1_000_000,
        save_every: int = 10_000,
        sample_every: int = 5_000,
        sample_reference_audio: str | None = None,
        sample_reference_text: str | None = None,
        sample_generation_text: str | None = None,
        sample_generation_duration: float | None = None,
        checkpoint: int | str | None = None,  # step number or "latest"
        log_every: int = 10,
        seed: int = 0,
        on_device_mel: bool = False,
        grad_accum: int = 1,
    ) -> None:
        """Main loop. `train_dataset` yields dicts with "mel_spec" [b, n, d]
        (or [b, 1, n, d]), "mel_len" [b] and "transcript" [b, nt] int ids
        padded with -1 — or, with on_device_mel=True, "audio" [b, n_samples]
        whose mel is computed inside the step on the model's device.

        `grad_accum=k > 1` splits each yielded batch into k microbatches
        before one update; the step counter, schedule, EMA and checkpoints
        count updates."""
        if self.log_with_wandb:
            import wandb

            wandb.init(project="f5tts", config=dict(learning_rate=learning_rate, total_steps=total_steps))
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

        optimizer = make_optimizer(learning_rate, weight_decay, self.num_warmup_steps, total_steps,
                                   self.max_grad_norm)
        self.state = init_train_state(self.model.dit, optimizer, ema=self.ema_decay is not None)
        if checkpoint == "latest":
            checkpoint = C.latest_checkpoint_step(self.results_dir, "f5tts_")
            if checkpoint is None:
                print("No checkpoint found; starting fresh")
        start_step = 0
        if checkpoint is not None:
            self.load_checkpoint(checkpoint)
            start_step = checkpoint
            print(f"Starting training at step {start_step}")

        cfm_cfg = self.model.cfm_cfg
        if on_device_mel:
            step_fn = make_train_step_from_audio(cfm_cfg, optimizer, self.ema_decay, self.model.audio_cfg, grad_accum)
        else:
            step_fn = make_train_step(cfm_cfg, optimizer, self.ema_decay, grad_accum)

        device = self.model.device
        global_step = start_step
        start_date = datetime.datetime.now()
        try:
            for batch in train_dataset:
                if on_device_mel:
                    inp = torch.as_tensor(np.asarray(batch["audio"], np.float32), device=device)
                    seq_len = inp.shape[1] // self.model.audio_cfg.hop_length
                else:
                    inp = torch.as_tensor(np.asarray(batch["mel_spec"], np.float32), device=device)
                    if inp.ndim == 4:  # [b, 1, n, d] from per-item mel transforms
                        inp = inp[:, 0]
                    seq_len = inp.shape[1]
                lens = torch.as_tensor(np.asarray(batch["mel_len"], np.int32).reshape(-1), device=device)
                text = batch_text(batch, seq_len, device)
                inp, text, lens = split_microbatches(grad_accum, inp, text, lens)

                loss = step_fn(self.state, inp, text, lens, step_generator(device, seed, global_step))
                global_step += 1
                if global_step % log_every == 0 or global_step == start_step + 1:
                    loss_val, batch_len = float(loss), int(lens.sum())
                    lr = optimizer.schedule(global_step - 1)
                    if self.log_with_wandb:
                        import wandb

                        wandb.log({"loss": loss_val, "batch_len": batch_len, "lr": lr}, step=global_step)
                    print(f"step {global_step}/{total_steps}: loss {loss_val:.4f} batch_len {batch_len} lr {lr:.3e}")
                if global_step % save_every == 0:
                    self.save_checkpoint(global_step)
                if (global_step % sample_every == 0 and sample_reference_audio is not None
                        and sample_reference_text is not None and sample_generation_text is not None
                        and sample_generation_duration is not None):
                    self.generate_sample(sample_reference_audio, sample_reference_text, sample_generation_text,
                                         sample_generation_duration, global_step)
                if global_step >= total_steps:
                    break
        finally:
            if self.log_with_wandb:
                import wandb

                wandb.finish()
        print(f"Training complete in {datetime.datetime.now() - start_date}")
