"""Conditional flow-matching sampling and the F5TTS API (the port of the JAX
package's `models/cfm.py`: the fused zero-shot synthesis path, the
weight-only int4/int8 quantized DiT and the duration predictor).

Classifier-free guidance runs cond and uncond as one 2B-batch forward with
per-sample drop flags. Durations are padded to a bucket (multiples of
`CFMConfig.duration_bucket` frames); padded tails are masked in attention,
zeroed in the mel, and excluded from the vocoder's ISTFT.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import math
import os
from pathlib import Path
from typing import Literal

import numpy as np
import torch

from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram
from f5_tts_tpu_torch.config import AudioConfig, CFMConfig, DiTConfig
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.ode import odeint
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.utils.masks import lens_to_mask
from f5_tts_tpu_torch.utils.modules import init_parameters_
from f5_tts_tpu_torch.utils.tokenizer import list_str_to_idx, list_str_to_tensor


def cfm_sample_mel(
    dit: DiT,
    y0: torch.Tensor,  # [b, n, d] noise (zeroed past each item's duration)
    step_cond: torch.Tensor,  # [b, n, d] fixed conditioning
    text: torch.Tensor,  # [b, n] int ids padded with -1
    mask: torch.Tensor | None,  # [b, n] bool duration mask
    ts: np.ndarray,  # [steps] float32 time grid
    method: str = "rk4",
    cfg_strength: float = 2.0,
    return_trajectory: bool = True,
) -> torch.Tensor:
    """Integrate the flow ODE in float32; returns the trajectory
    [steps, b, n, d], or [1, b, n, d] (the final state) when
    return_trajectory=False. The text embeddings and every step's AdaLN
    modulations are computed once, before integrating."""
    b, n = y0.shape[0], y0.shape[1]

    def schedule_fn(times: np.ndarray) -> dict:
        return dit.time_mods(torch.from_numpy(times).to(y0.device))

    if cfg_strength < 1e-5:
        text_embed = dit.embed_text(text, n, drop_text=False)

        def fn(t, x, mods):
            return dit(x, step_cond, text_embed, mods, drop_audio_cond=False, mask=mask)
    else:
        step_cond2 = torch.cat([step_cond, step_cond])
        mask2 = torch.cat([mask, mask]) if mask is not None else None
        drop = torch.cat([torch.zeros(b, dtype=torch.bool), torch.ones(b, dtype=torch.bool)]).to(y0.device)
        text_embed2 = torch.cat(
            [dit.embed_text(text, n, drop_text=False), dit.embed_text(text, n, drop_text=True)]
        )

        def fn(t, x, mods):
            pred2 = dit(torch.cat([x, x]), step_cond2, text_embed2, mods, drop_audio_cond=drop, mask=mask2)
            pred, null_pred = pred2[:b], pred2[b:]
            return pred + (pred - null_pred) * cfg_strength

    return odeint(fn, y0.float(), ts, method, return_trajectory=return_trajectory, schedule_fn=schedule_fn)


def cfm_sample_e2e(
    dit: DiT,
    cond: torch.Tensor,  # [b, padded_len, d] mel, padded to the bucket
    lens: torch.Tensor,  # [b] reference lengths in frames
    duration: torch.Tensor,  # [b] total durations in frames
    max_dur: int,  # duration.max()
    text: torch.Tensor,  # [b, padded_len] int ids padded with -1
    ts: np.ndarray,  # [steps] time grid
    y0: torch.Tensor | None,  # [b, n, d] noise, or None to draw from seed
    seed: int,  # ignored when y0 is given
    vocoder: Vocos | None,
    *,
    method: str,
    cfg_strength: float,
    return_trajectory: bool,
    shared_noise: bool,
):
    """Masks and conditioning -> ODE -> composite with the reference ->
    vocoder at the bucket length with `valid_frames=max_dur`.

    Returns (mel [b, padded_len, d] zeroed past max_dur, trajectory,
    wave [b, (padded_len - 1) * hop] or None)."""
    cond = cond.float()
    b, padded_len, d = cond.shape
    device = cond.device
    cond_mask = lens_to_mask(lens, padded_len)[..., None]
    step_cond = torch.where(cond_mask, cond, torch.zeros_like(cond))
    dur_mask = lens_to_mask(duration, padded_len)

    if y0 is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        if shared_noise:
            # a fixed seed gives the SAME noise to every batch row, as the
            # reference does
            y0 = torch.randn(padded_len, d, generator=gen, device=device).expand(b, padded_len, d)
        else:
            y0 = torch.randn(b, padded_len, d, generator=gen, device=device)
    else:
        y0 = torch.nn.functional.pad(y0.float(), (0, 0, 0, padded_len - y0.shape[1]))
    y0 = y0 * dur_mask[..., None]

    trajectory = cfm_sample_mel(
        dit, y0, step_cond, text, dur_mask, ts, method=method, cfg_strength=cfg_strength,
        return_trajectory=return_trajectory,
    )
    frame_valid = (torch.arange(padded_len, device=device) < max_dur)[None, :, None]
    out = torch.where(cond_mask, cond, trajectory[-1])
    out = torch.where(frame_valid, out, torch.zeros_like(out))
    wave = vocoder.decode(out, valid_frames=max_dur) if vocoder is not None else None
    return out, trajectory, wave


def clamp_duration(
    duration: np.ndarray, lens: np.ndarray, text_lens: np.ndarray, max_duration: int
) -> np.ndarray:
    """Durations are at least max(text_lens, ref_lens) + 1 frames and at most
    max_duration."""
    eff_lens = np.maximum(np.asarray(text_lens, np.int32), np.asarray(lens, np.int32))
    duration = np.maximum(eff_lens + 1, np.asarray(duration, np.int32))
    return np.clip(duration, 0, max_duration)


def sway_time_grid(steps: int, sway_sampling_coef: float | None, t_start: float = 0.0) -> np.ndarray:
    """linspace warped by sway sampling t += s*(cos(pi/2 t) - 1 + t)."""
    t = np.linspace(t_start, 1.0, steps, dtype=np.float32)
    if sway_sampling_coef is not None:
        t = t + sway_sampling_coef * (np.cos(np.pi / 2 * t) - 1 + t)
    return t


class F5TTS:
    """Flow-matching TTS model: the DiT plus host-side wiring (tokenizer
    vocab, mel front-end, vocoder, optional duration predictor)."""

    def __init__(
        self,
        dit: DiT,
        dit_cfg: DiTConfig,
        cfm_cfg: CFMConfig = CFMConfig(),
        audio_cfg: AudioConfig = AudioConfig(),
        vocab_char_map: dict[str, int] | None = None,
        vocoder: Vocos | None = None,
        duration_predictor: DurationPredictor | None = None,
    ):
        self.dit = dit
        self.dit_cfg = dit_cfg
        self.cfm_cfg = cfm_cfg
        self.audio_cfg = audio_cfg
        self.vocab_char_map = vocab_char_map
        self.vocoder = vocoder
        self.duration_predictor = duration_predictor
        self._cast_cache: tuple | None = None

    @property
    def device(self) -> torch.device:
        return next(self.dit.parameters()).device

    # -- construction ------------------------------------------------------

    @classmethod
    def init(
        cls,
        generator: torch.Generator,
        dit_cfg: DiTConfig = DiTConfig(),
        device: torch.device | str = "cpu",
        **kwargs,
    ) -> "F5TTS":
        """Random weights drawn from `generator`, which must live on `device`."""
        with torch.device(device):
            dit = DiT(dit_cfg)
        init_parameters_(dit, generator)
        return cls(dit, dit_cfg, **kwargs)

    @classmethod
    def from_pretrained(
        cls, local_dir: str | Path, device: torch.device | str = "cpu", quantization_bits: int | None = None
    ) -> "F5TTS":
        """Load a snapshot directory (see models/convert.py); with
        `quantization_bits` (4 or 8), its weight-only quantized DiT."""
        from f5_tts_tpu_torch.models.convert import load_f5tts_pretrained

        return load_f5tts_pretrained(local_dir, device, quantization_bits)

    def save_pretrained(self, path: str | Path, quantization_bits: int | None = None) -> None:
        """Write a snapshot directory in the published layouts: the float DiT
        as model_v1.safetensors (torch-EMA naming) or, with
        `quantization_bits`, quantized as model_v1_{bits}b.safetensors (MLX
        naming); vocab.txt, duration_v2.safetensors, vocos/model.safetensors
        and config.json. Either package's from_pretrained loads it. The DiT
        must hold float weights."""
        from f5_tts_tpu_torch.models.convert import (
            export_dit_state,
            export_duration_state,
            export_mlx_state,
            export_vocos_state,
            to_mlx_model_naming,
        )
        from f5_tts_tpu_torch.models.quant import quantize_flat_mlx
        from f5_tts_tpu_torch.utils.safetensors import save_file

        path = Path(path)
        os.makedirs(path, exist_ok=True)
        if quantization_bits is None:
            save_file(export_dit_state(self.dit), path / "model_v1.safetensors")
        else:
            flat = to_mlx_model_naming(export_mlx_state(self.dit), self.dit_cfg.dim_head)
            save_file(quantize_flat_mlx(flat, quantization_bits),
                      path / f"model_v1_{quantization_bits}b.safetensors")
        if self.vocab_char_map is not None:
            entries = sorted(self.vocab_char_map, key=self.vocab_char_map.get)
            (path / "vocab.txt").write_text("\n".join(entries))
        cfg_blob = {
            "dit": dataclasses.asdict(self.dit_cfg),
            "audio": dataclasses.asdict(self.audio_cfg),
            "cfm": dataclasses.asdict(self.cfm_cfg),
        }
        if self.duration_predictor is not None:
            save_file(export_duration_state(self.duration_predictor), path / "duration_v2.safetensors")
            cfg_blob["duration"] = dataclasses.asdict(self.duration_predictor.cfg)
        if self.vocoder is not None:
            cfg_blob["vocos"] = dataclasses.asdict(self.vocoder.cfg)
            os.makedirs(path / "vocos", exist_ok=True)
            save_file(export_vocos_state(self.vocoder), path / "vocos" / "model.safetensors")
        (path / "config.json").write_text(json.dumps(cfg_blob, indent=2))

    # -- helpers -----------------------------------------------------------

    def _tokenize(self, text: list[str]) -> np.ndarray:
        if self.vocab_char_map is not None:
            return list_str_to_idx(text, self.vocab_char_map)
        return list_str_to_tensor(text)

    def _inference_dit(self) -> DiT:
        """The DiT in its compute dtype. For bf16 a cast copy is kept (every
        float tensor cast, a quantized linear's scales and biases included;
        int8 codes stay), rebuilt when any parameter or buffer is replaced or
        modified in place. LayerNorm and GRN statistics, the timestep
        sinusoid, the DiT output and the ODE state stay float32 all the
        same."""
        dtype = self.dit.compute_dtype
        if dtype == torch.float32:
            return self.dit
        key = tuple((t.data_ptr(), t._version) for t in itertools.chain(self.dit.parameters(), self.dit.buffers()))
        if self._cast_cache is None or self._cast_cache[0] != key:
            self._cast_cache = (key, copy.deepcopy(self.dit).to(dtype))
        return self._cast_cache[1]

    # -- duration ----------------------------------------------------------

    def predict_duration(self, cond, text, speed: float = 1.0, *, lens=None) -> np.ndarray:
        """Predicted total duration in frames, [b] int32: the predictor's
        seconds times the integer frame rate sample_rate // hop_length,
        divided by `speed`. `cond` is a mel [b, n, d] (or raw wave [b, nw]),
        `text` the ids [b, nt]; `lens` masks each item's reference length."""
        seconds = self.duration_predictor(cond, text, lens=lens).cpu().numpy()
        frame_rate = self.audio_cfg.sample_rate // self.audio_cfg.hop_length
        return (seconds * frame_rate / speed).astype(np.int32)

    # -- sampling ----------------------------------------------------------

    @torch.no_grad()
    def sample(
        self,
        cond,  # [b, n, d] mel or [1, nw] raw wave (tensor or array)
        text: list[str] | np.ndarray,
        duration: int | np.ndarray | None = None,
        *,
        lens: np.ndarray | None = None,
        steps: int = 8,
        method: Literal["euler", "midpoint", "rk4"] = "rk4",
        cfg_strength: float = 2.0,
        speed: float = 1.0,
        sway_sampling_coef: float | None = -1.0,
        seed: int | None = None,
        max_duration: int | None = None,
        y0=None,
        return_trajectory: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Zero-shot synthesis.

        Returns (waveform, trajectory), or (mel, trajectory) without a
        vocoder. The output is trimmed to the longest duration; the
        trajectory is [steps, b, n, d] (or the final state [1, b, n, d]).
        `y0` overrides the initial noise; `seed` fixes it, shared by every
        batch row. With `duration=None` the duration predictor sets each
        item's total duration from the reference mel and the text, scaled by
        1 / `speed`."""
        device = self.device
        max_duration = max_duration or self.cfm_cfg.max_duration
        cond = torch.as_tensor(cond, device=device)
        is_wave = cond.ndim == 2
        if is_wave:
            if cond.shape[0] != 1:
                raise ValueError(
                    f"raw-wave cond must have batch 1, got {cond.shape[0]}; "
                    "pass precomputed mel [b, n, d] for batched sampling"
                )
            cond = log_mel_spectrogram(
                cond.reshape(-1), self.audio_cfg.sample_rate, self.audio_cfg.n_mels,
                self.audio_cfg.n_fft, self.audio_cfg.hop_length,
            )
        if cond.shape[-1] != self.audio_cfg.n_mels:
            raise ValueError(f"cond has {cond.shape[-1]} mel channels, expected {self.audio_cfg.n_mels}")
        cond = cond.float()
        batch, cond_seq_len = cond.shape[0], cond.shape[1]
        lens_np = (
            np.full((batch,), cond_seq_len, dtype=np.int32)
            if lens is None
            else np.asarray(lens, dtype=np.int32)
        )

        text_np = np.asarray(self._tokenize(text) if isinstance(text, list) else text, dtype=np.int32)
        if text_np.shape[0] != batch:
            raise ValueError(f"{text_np.shape[0]} texts for a batch of {batch}")
        if text_np.size and int(text_np.max()) >= self.dit_cfg.text_num_embeds:
            raise ValueError(
                f"text id {int(text_np.max())} out of range for "
                f"text_num_embeds={self.dit_cfg.text_num_embeds}; the vocab "
                "used for tokenization does not match the model config"
            )
        text_lens = (text_np != -1).sum(axis=-1).astype(np.int32)
        lens_np = np.maximum(text_lens, lens_np)

        if duration is None:
            if self.duration_predictor is None:
                raise ValueError("Duration must be provided or a duration predictor must be set.")
            duration = self.predict_duration(cond, text_np, speed)
        if isinstance(duration, (int, np.integer)):
            duration = np.full((batch,), duration, dtype=np.int32)
        duration = clamp_duration(duration, lens_np, text_lens, max_duration)
        max_dur = int(duration.max())

        bucket = self.cfm_cfg.duration_bucket
        padded_len = max(bucket, math.ceil(max_dur / bucket) * bucket)
        if int(lens_np.max()) >= padded_len:
            raise ValueError(
                f"reference audio ({int(lens_np.max())} frames) does not fit "
                f"the max_duration window ({max_duration} frames, "
                f"{max_duration / self.audio_cfg.frames_per_second:.1f}s "
                "including the generated region); pass a shorter reference "
                "clip or raise max_duration"
            )

        text_ids = np.full((batch, padded_len), -1, dtype=np.int32)
        ncopy = min(text_np.shape[1], padded_len)
        text_ids[:, :ncopy] = text_np[:, :ncopy]

        if cond.shape[1] < padded_len:
            cond = torch.nn.functional.pad(cond, (0, 0, 0, padded_len - cond.shape[1]))
        else:
            cond = cond[:, :padded_len]
        seed_val = int(seed) if seed is not None else int(np.random.randint(0, 2**31 - 1))
        out, trajectory, wave = cfm_sample_e2e(
            self._inference_dit(),
            cond,
            torch.as_tensor(lens_np, device=device),
            torch.as_tensor(duration, device=device),
            max_dur,
            torch.as_tensor(text_ids, device=device),
            sway_time_grid(steps, sway_sampling_coef),
            None if y0 is None else torch.as_tensor(y0, device=device),
            seed_val,
            self.vocoder,
            method=method,
            cfg_strength=float(cfg_strength),
            return_trajectory=return_trajectory,
            shared_noise=seed is not None,
        )
        trajectory = trajectory[:, :, :max_dur]
        if wave is None:
            return out[:, :max_dur], trajectory
        wave = wave[:, : (max_dur - 1) * self.audio_cfg.hop_length]
        if batch == 1:
            wave = wave.reshape(-1)
        return wave, trajectory

