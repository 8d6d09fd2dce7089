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
from torch.profiler import record_function

from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram
from f5_tts_tpu_torch.config import AudioConfig, CFMConfig
from f5_tts_tpu_torch.models.blocks import draw_seeds
from f5_tts_tpu_torch.models.cfm import F5TTS, CFMDraws, cfm_loss, cfm_span, cfm_terms, draw_cfm
from f5_tts_tpu_torch.models.convert import (
    convert_dit_state,
    export_mlx_state,
    mlx_names,
    state_numpy,
    to_mlx_model_naming,
)
from f5_tts_tpu_torch.models.shard import shard_train_state
from f5_tts_tpu_torch.parallel import distributed as D
from f5_tts_tpu_torch.parallel.mesh import (
    ShardedTrainState,
    create_mesh,
    gather_state,
    refuse_stage,
    shard_train_step,
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
    def update_(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], opt_state: dict,
                norm: torch.Tensor | None = None) -> None:
        """One update of `params` and `opt_state`, in place. `norm` is the
        global gradient norm when the caller took it (a shard's update
        clips by the whole gradient's norm), else it is taken over
        `grads`."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [opt_state["mu"][k] for k in names]
        nu = [opt_state["nu"][k] for k in names]
        if self.max_grad_norm > 0:
            if norm is None:
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


def dropout_seeds(model, generator: torch.Generator | None) -> list[int] | None:
    """The layers' dropout seeds of one forward of `model` (a model or a
    group of its shards: anything with its `cfg`), drawn from `generator`
    as the model's own forward draws them (after the loss's draws), or None
    without dropout."""
    cfg = model.cfg
    if generator is None or cfg.dropout <= 0.0:
        return None
    return draw_seeds(generator, cfg.depth)


class CFMObjective:
    """The CFM loss as both steps take it. The unsharded step calls `loss`;
    the sharded one (parallel/mesh.py `ShardedStep`) draws the global
    batch's randomness (`draw`, `seeds`), takes each data row's share
    (`take`), and sums each row's `numerator` over the global `count` (the
    span's elements). With an `audio_cfg` the inputs are raw audio and
    `prepare` computes the log-mel on their device, frames past each
    length re-zeroed (the training forward has no attention mask, so the
    padding value counts)."""

    def __init__(self, cfm_cfg: CFMConfig, audio_cfg: AudioConfig | None = None):
        self.cfm_cfg = cfm_cfg
        self.audio_cfg = audio_cfg

    def prepare(self, inp: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        if self.audio_cfg is None:
            return inp
        a = self.audio_cfg
        mel = log_mel_spectrogram(inp, a.sample_rate, a.n_mels, a.n_fft, a.hop_length)
        frames = torch.arange(mel.shape[1], device=mel.device)[None, :]
        return torch.where((frames < lens[:, None])[..., None], mel, torch.zeros_like(mel))

    def loss(self, dit, inp, text, lens, generator, draws) -> torch.Tensor:
        return cfm_loss(dit, self.cfm_cfg, self.prepare(inp, lens), text, lens, generator=generator, draws=draws)

    def draw(self, generator: torch.Generator, batch: int, mel: torch.Tensor) -> CFMDraws:
        return draw_cfm(generator, self.cfm_cfg, batch, mel.shape[1], mel.shape[2], mel.device)

    @staticmethod
    def take(draws: CFMDraws, sl: slice, device=None) -> CFMDraws:
        return draws.rows(sl, device)

    seeds = staticmethod(dropout_seeds)

    @staticmethod
    def count(mel: torch.Tensor, lens: torch.Tensor, draws: CFMDraws) -> torch.Tensor:
        return (cfm_span(lens, draws, mel.shape[1]).sum() * mel.shape[2]).float()

    def numerator(self, group, mel, text, lens, draws, seeds, rows) -> torch.Tensor:
        return cfm_terms(group, self.cfm_cfg, mel, text, lens, draws, seeds=seeds, rows=rows)[0]


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """What a step does with its gradients, shared by the unsharded step
    (`_build_step`) and the sharded one (parallel/mesh.py `ShardedStep`),
    each over dicts of tensors by name: `accumulate` the microbatches'
    gradients, then `apply_` the clip, AdamW and the EMA."""

    optimizer: AdamW
    ema_decay: float | None
    grad_accum: int

    def accumulate(self, micro: Callable) -> tuple[torch.Tensor, list[dict]]:
        """The step's loss and gradients from `micro(i) -> (loss, grads)`:
        microbatch i's detached float32 loss and its gradients, a list of
        dicts name -> tensor (one dict unsharded, one a slot sharded).
        grad_accum == 1: `micro(None)`, the batch as it is. grad_accum == k
        > 1: the float32 sum of the k microbatches' gradients divided by k,
        each in its own dtype again, and the microbatches' mean loss."""
        k = self.grad_accum
        if k <= 1:
            return micro(None)
        acc, dtypes, loss = None, None, 0.0
        for i in range(k):
            loss_i, g_i = micro(i)
            if acc is None:
                dtypes = [{n: g.dtype for n, g in d.items()} for d in g_i]
                # a copy: the slots of one device may be handed one tensor
                acc = [{n: g.to(torch.float32, copy=True) for n, g in d.items()} for d in g_i]
            else:
                for a, d in zip(acc, g_i):
                    torch._foreach_add_(list(a.values()), [d[n].float() for n in a])
            loss = loss + loss_i
        for a in acc:
            torch._foreach_div_(list(a.values()), float(k))
        return loss / k, [{n: g.to(dt[n]) for n, g in a.items()} for a, dt in zip(acc, dtypes)]

    @torch.no_grad()
    def apply_(self, params: dict, grads: dict, opt_state: dict, ema: dict | None,
               norm: torch.Tensor | None = None) -> None:
        """AdamW on `params` and `opt_state` in place (clipped by `norm`,
        the whole gradient's norm, when given, else by `grads`' own), then
        the optional EMA e <- d e + (1 - d) p on the updated parameters."""
        with record_function("train.update"):
            self.optimizer.update_(params, grads, opt_state, norm=norm)
            if self.ema_decay is not None:
                e = [ema[name] for name in params]
                torch._foreach_mul_(e, self.ema_decay)
                torch._foreach_add_(e, list(params.values()), alpha=1.0 - self.ema_decay)


def _build_step(objective, optimizer: AdamW, ema_decay: float | None, grad_accum: int):
    """The train step shared by both trainers, around `objective.loss(model,
    inp, text, lens, generator, draws) -> scalar`. The step is `(state, inp,
    text, lens, generator=None, draws=None) -> loss` and updates `state` in
    place. It carries what parallel/mesh.py `shard_train_step` needs to run
    it over a grid (`objective`, and `rule`, its `UpdateRule`).

    grad_accum == 1: one forward and backward, clip and AdamW, then the
    optional EMA e <- d e + (1 - d) p on the updated parameters. The step
    and its parts are `torch.profiler.record_function` ranges, which a
    running profiler records beside the kernels they launch: `train.step`
    around it all, `train.forward` and `train.backward` a microbatch,
    `train.update` around `UpdateRule.apply_`.

    grad_accum == k > 1: inputs carry a leading microbatch axis [k, b, ...]
    (and `draws`, when given, is a list of k); k forward and backward passes,
    each drawing its own randomness from the generator, a float32 gradient
    sum divided by k, and one update. The loss is the microbatches' mean."""
    rule = UpdateRule(optimizer, ema_decay, int(grad_accum))

    def train_step(state: TrainState, inp, text, lens, generator=None, draws=None) -> torch.Tensor:
        with record_function("train.step"):
            params = state.params
            tensors = list(params.values())

            def micro(i):
                with record_function("train.forward"):
                    if i is None:
                        loss = objective.loss(state.model, inp, text, lens, generator, draws)
                    else:
                        loss = objective.loss(state.model, inp[i], text[i], lens[i], generator,
                                              None if draws is None else draws[i])
                with record_function("train.backward"):
                    grads = _grads(loss, tensors)
                return loss.detach().float(), [dict(zip(params, grads))]

            loss, (grads,) = rule.accumulate(micro)
            rule.apply_(params, grads, state.opt_state, state.ema)
            state.step += 1
        return loss

    train_step.objective, train_step.rule = objective, rule
    return train_step


def make_train_step(cfm_cfg: CFMConfig, optimizer: AdamW, ema_decay: float | None = None, grad_accum: int = 1):
    """The step on mel batches [b, n, d] (or [k, b, n, d] with
    `grad_accum=k`), for a TrainState over the DiT; see `_build_step`."""
    return _build_step(CFMObjective(cfm_cfg), optimizer, ema_decay, grad_accum)


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
    return _build_step(CFMObjective(cfm_cfg, audio_cfg or AudioConfig()), optimizer, ema_decay, grad_accum)


def split_microbatches(grad_accum: int, *arrays, data_size: int | None = None):
    """Reshape per-batch arrays [b, ...] into [grad_accum, b // grad_accum,
    ...] for an accumulated step; unchanged when grad_accum == 1. Raises
    ValueError when the batch does not divide, or when, under a mesh
    (`data_size`: its data axis), the microbatch does not split evenly over
    the data rows."""
    b = arrays[0].shape[0]
    if b % grad_accum:
        raise ValueError(f"batch size {b} is not divisible by grad_accum={grad_accum}")
    micro = b // grad_accum
    if data_size and micro % data_size:
        raise ValueError(f"microbatch size {micro} (batch {b} / grad_accum {grad_accum}) "
                         f"is not divisible by the mesh's data-axis size {data_size}")
    if grad_accum <= 1:
        return arrays
    return tuple(a.reshape(grad_accum, micro, *a.shape[1:]) for a in arrays)


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


def training_grid(mesh, device: torch.device):
    """The grid a trainer trains over: its `mesh`; without one, a grid of
    one slot on the model's device when several processes run (the
    sharded step is the one that sums the gradient across them), else None
    (the unsharded step)."""
    if mesh is None and D.process_count() > 1:
        return create_mesh(data=1, devices=[device])
    return mesh


def gathered_train_state(state, model: nn.Module) -> TrainState:
    """A sharded train state (parallel/mesh.py `ShardedTrainState`) as an
    unsharded `TrainState` over `model`: the stored pieces gathered into
    the model's parameters (in place), the moments and the EMA into full
    tensors. An unsharded state is returned as it is."""
    if isinstance(state, TrainState):
        return state
    full = gather_state(state)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(full["params"][name])
    return TrainState(model, {"mu": full["mu"], "nu": full["nu"], "count": full["count"]}, full["step"], full["ema"])


class F5TTSTrainer:
    """Training loop, checkpoints and probe samples for an `F5TTS` model's DiT.

    `mesh` (parallel/mesh.py `create_mesh`) trains over a grid: DP over its
    "data" axis (spanning the processes when `parallel.initialize()` started
    several), TP over "model" and sequence parallelism over "seq" (the
    frames of each batch split over the seq slots, within a process; a
    batch's frames must divide by it); `fsdp=True` also shards the weight
    matrices, their moments and EMA over the global data axis, every
    process's data rows (no effect without a mesh in one process, as in the
    JAX package). Without a mesh, several processes train over a grid of
    one slot each (`training_grid`), so their gradients are summed, or under
    `fsdp` reduce-scattered over one row a process. `use_orbax=True` keeps
    the whole train state,
    sharded, in an asynchronous checkpoint manager (training/checkpoints.py
    `TrainCheckpointManager`, over torch.distributed.checkpoint) beside the
    MLX-named weight files. With several processes, process 0 alone writes
    the files and the probe samples."""

    def __init__(
        self,
        model: F5TTS,
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
            refuse_stage(mesh, "F5TTSTrainer(mesh=)")
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
        """Weights in full-model MLX naming ("transformer." prefix and the
        rotary inv_freq), which the reference and the JAX package's
        `convert_dit_state` load; the EMA weights beside them; and the
        optimizer state and step for an exact resume: in the checkpoint
        manager (sharded, asynchronous) with `use_orbax`, else a
        .trainstate file. A sharded state is gathered for the files. Every
        process calls it (the manager saves across them); process 0 alone
        writes the files."""
        os.makedirs(self.results_dir, exist_ok=True)
        dim_head = self.model.dit_cfg.dim_head
        state = None if self.state is None else gathered_train_state(self.state, self.model.dit)
        writer = D.process_index() == 0
        if writer:
            save_file(to_mlx_model_naming(export_mlx_state(self.model.dit), dim_head),
                      self.results_dir / f"f5tts_{step}.safetensors")
        if state is not None:
            if state.ema is not None and writer:
                save_file(to_mlx_model_naming(mlx_names(state_numpy(state.ema)), dim_head),
                          self.results_dir / f"f5tts_{step}.ema.safetensors")
            if self.ckpt_mgr is not None:
                self.ckpt_mgr.save(step, self.state)
            elif writer:
                C.save_train_state(state, self.results_dir / f"f5tts_{step}.trainstate.safetensors")

    def load_checkpoint(self, step: int) -> None:
        """The step's weights into the model, and with a train state its
        EMA, moments and step (a sharded state is re-sharded from them)."""
        cfg = self.model.dit_cfg
        flat = load_file(self.results_dir / f"f5tts_{step}.safetensors")
        state = None if self.state is None else gathered_train_state(self.state, self.model.dit)
        self.model.dit.load_state_dict(convert_dit_state(flat, cfg))
        if state is not None:
            ema_path = self.results_dir / f"f5tts_{step}.ema.safetensors"
            if state.ema is not None and ema_path.exists():
                for k, v in convert_dit_state(load_file(ema_path), cfg).items():
                    state.ema[k].copy_(v)
            C.restore_train_state_file(state, self.results_dir / f"f5tts_{step}.trainstate.safetensors",
                                       "a weights-only resume restarts the schedule")
            if not isinstance(self.state, TrainState):
                self.state = shard_train_state(state, self.state.mesh, self.state.fsdp)

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
        matplotlib and PIL are installed). Every process calls it (a sharded
        state is gathered, across the processes under FSDP); process 0 alone
        samples."""
        from f5_tts_tpu_torch.audio.io import read_wav, write_wav

        state = None if self.state is None else gathered_train_state(self.state, self.model.dit)
        if D.process_index() != 0:
            return

        acfg = self.model.audio_cfg
        audio, _ = read_wav(sample_audio)
        if audio.ndim > 1:
            audio = audio.mean(axis=-1)
        ref_audio_duration = audio.shape[0] / acfg.sample_rate
        rms = float(np.sqrt(np.mean(np.square(audio))))
        if rms < TARGET_RMS:
            audio = audio * TARGET_RMS / rms

        model = self.model
        if state is not None and state.ema is not None:
            dit = copy.deepcopy(model.dit)
            dit.load_state_dict(state.ema)
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
        if self.use_orbax:
            self.ckpt_mgr = C.TrainCheckpointManager(self.results_dir / "checkpoints")
        start_step = C.resume(self, checkpoint, "f5tts_")

        cfm_cfg = self.model.cfm_cfg
        if on_device_mel:
            step_fn = make_train_step_from_audio(cfm_cfg, optimizer, self.ema_decay, self.model.audio_cfg, grad_accum)
        else:
            step_fn = make_train_step(cfm_cfg, optimizer, self.ema_decay, grad_accum)
        device = self.model.device
        data_size = None
        mesh = training_grid(self.mesh, device)
        if mesh is not None:
            self.state = shard_train_state(self.state, mesh, fsdp=self.fsdp)
            step_fn = shard_train_step(step_fn, mesh, self.state, grad_accum=grad_accum, fsdp=self.fsdp)
            device, data_size = self.state.slots[0].device, mesh.shape["data"]

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
                inp, text, lens = split_microbatches(grad_accum, inp, text, lens, data_size=data_size)

                loss = step_fn(self.state, inp, text, lens, step_generator(device, seed, global_step))
                self.last_loss = loss
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
            gathered_train_state(self.state, self.model.dit)  # the caller's model holds the trained weights
            if self.ckpt_mgr is not None:
                self.ckpt_mgr.wait()  # pending asynchronous writes finish even when the loop raised
            if self.log_with_wandb:
                import wandb

                wandb.finish()
        print(f"Training complete in {datetime.datetime.now() - start_date}")
