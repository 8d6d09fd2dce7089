"""Conditional flow matching: the training loss, sampling and the F5TTS API
(the port of the JAX package's `models/cfm.py`: the masked-infill training
loss, the fused zero-shot synthesis path and its guidance-interval
segments, the weight-only int4/int8 quantized DiT and the duration
predictor, and W8A8 int8 compute).

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
from f5_tts_tpu_torch.models.dit import DiT, require_dit
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.ode import odeint
from f5_tts_tpu_torch.models.quant import w8a8_blocks_
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.models.shard import shard_model_for_inference
from f5_tts_tpu_torch.parallel.mesh import gather_batch, pad_batch, refuse_stage, seq_frames, split_batch
from f5_tts_tpu_torch.utils.masks import lens_to_mask, mask_from_frac_lengths
from f5_tts_tpu_torch.utils.modules import init_parameters_
from f5_tts_tpu_torch.utils.sampling import clamp_duration, draw_noise, sway_time_grid
from f5_tts_tpu_torch.utils.tokenizer import list_str_to_idx, list_str_to_tensor


@dataclasses.dataclass
class CFMDraws:
    """The random draws of one `cfm_loss` call. Tests fill them with the
    JAX package's draws; training draws them from a generator
    (`draw_cfm`)."""

    frac_lengths: torch.Tensor  # [b] span fraction, U(lo, hi)
    span_start: torch.Tensor  # [b] U(0, 1), places each span
    x0: torch.Tensor  # [b, n, mel] N(0, 1) noise
    time: torch.Tensor  # [b] U(0, 1) flow time
    audio_drop: torch.Tensor  # [1] U(0, 1), audio dropped below audio_drop_prob
    text_drop: torch.Tensor  # [1] U(0, 1), text dropped below cond_drop_prob

    def rows(self, sl: slice, device: torch.device | None = None) -> "CFMDraws":
        """The draws of the batch rows `sl` (the CFG drops are the whole
        batch's), on `device` when given."""
        def take(t, per_row=True):
            t = t[sl] if per_row else t
            return t if device is None else t.to(device, non_blocking=True)

        return CFMDraws(take(self.frac_lengths), take(self.span_start), take(self.x0), take(self.time),
                        take(self.audio_drop, False), take(self.text_drop, False))


def draw_cfm(generator: torch.Generator, cfm_cfg: CFMConfig, batch: int, seq_len: int, mel_dim: int,
             device: torch.device) -> CFMDraws:
    """Every draw of one loss from `generator`, made on its device."""
    gd = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=gd).to(device)

    lo, hi = cfm_cfg.frac_lengths_mask
    return CFMDraws(
        frac_lengths=lo + (hi - lo) * uniform(batch),
        span_start=uniform(batch),
        x0=torch.randn((batch, seq_len, mel_dim), generator=generator, device=gd).to(device),
        time=uniform(batch),
        audio_drop=uniform(1),
        text_drop=uniform(1),
    )


def cfm_loss(
    dit: DiT,
    cfm_cfg: CFMConfig,
    inp: torch.Tensor,  # [b, n, mel] mel
    text: torch.Tensor,  # [b, nt] int ids padded with -1
    lens: torch.Tensor,  # [b] int
    generator: torch.Generator | None = None,
    draws: CFMDraws | None = None,
) -> torch.Tensor:
    """Masked-infill flow-matching MSE, a float32 scalar: a random span of
    U(lo, hi) of each length is hidden from the cond, x0 ~ N(0, 1) and a
    per-sample time t ~ U(0, 1) give phi = (1 - t) x0 + t x1, the DiT
    predicts the flow x1 - x0 from phi, and the squared error is averaged
    over the span's elements only (denominator max(span frames * mel, 1e-6)).
    The CFG drops are decided per batch (audio dropped whenever text is), and
    no attention mask is passed, as in the reference's training forward.

    The draws come from `draws` when given, else from `generator`; the DiT's
    dropout (cfg.dropout > 0) needs the generator. Gradients flow to the
    DiT's parameters, which stay float32 while the forward runs in the
    config's compute dtype."""
    batch, seq_len, mel_dim = inp.shape
    if draws is None:
        draws = draw_cfm(generator, cfm_cfg, batch, seq_len, mel_dim, inp.device)
    squared, elements = cfm_terms(dit, cfm_cfg, inp, text, lens, draws, generator=generator)
    return squared / elements.clamp(min=1e-6)


def cfm_span(lens: torch.Tensor, draws: CFMDraws, seq_len: int) -> torch.Tensor:
    """The hidden span [b, n] of each length (inside its valid frames)."""
    return mask_from_frac_lengths(lens, draws.frac_lengths, draws.span_start, seq_len) & lens_to_mask(lens, seq_len)


def cfm_terms(dit, cfm_cfg: CFMConfig, inp: torch.Tensor, text: torch.Tensor, lens: torch.Tensor, draws: CFMDraws,
              **forward_kw) -> tuple[torch.Tensor, torch.Tensor]:
    """The loss's numerator and denominator: (the squared error summed over
    the span's elements, the span's element count in float32). A sharded
    step sums each data row's numerator over the global batch's count;
    `forward_kw` goes to `dit.forward_train` (a DiT, or a `DiTGroup` with
    the seeds and rows). Under sequence parallelism the group returns one
    prediction a seq slot, over its frames: each slot's squared error is
    taken against its frames of the flow and the span (built here from the
    global draws and lens), and the numerator is their sum."""
    seq_len, mel_dim = inp.shape[1], inp.shape[2]
    span = cfm_span(lens, draws, seq_len)

    x1 = inp.float()
    x0 = draws.x0.float()
    t = draws.time.float()[:, None, None]
    phi = (1 - t) * x0 + t * x1
    flow = x1 - x0
    cond = torch.where(span[..., None], torch.zeros_like(x1), x1)

    drop_text = draws.text_drop < cfm_cfg.cond_drop_prob
    drop_audio = (draws.audio_drop < cfm_cfg.audio_drop_prob) | drop_text
    pred = dit.forward_train(
        phi, cond, text, draws.time, drop_audio_cond=drop_audio[0], drop_text=drop_text[0], **forward_kw,
    )
    count = (span.sum() * mel_dim).float()
    if isinstance(pred, torch.Tensor):
        return torch.where(span[..., None], (pred - flow).square(), torch.zeros_like(pred)).sum(), count
    total = 0.0
    for frames, p in zip(seq_frames(len(pred), seq_len), pred):
        f, m = (frames.take(t).to(p.device, non_blocking=True) for t in (flow, span))
        total = total + torch.where(m[..., None], (p - f).square(), torch.zeros_like(p)).sum().to(inp.device)
    return total, count


def cfm_sample_mel(
    dit: DiT,
    y0: torch.Tensor,  # [b, n, d] noise (zeroed past each item's duration)
    step_cond: torch.Tensor,  # [b, n, d] fixed conditioning
    text: torch.Tensor,  # [b, n] int ids padded with -1
    mask: torch.Tensor | None,  # [b, n] bool duration mask
    ts: np.ndarray | torch.Tensor,  # [steps] float32 time grid (a tensor in a traced program)
    method: str = "rk4",
    cfg_strength: float = 2.0,
    return_trajectory: bool = True,
) -> torch.Tensor:
    """Integrate the flow ODE in float32; returns the trajectory
    [steps, b, n, d], or [1, b, n, d] (the final state) when
    return_trajectory=False. The text embeddings and every step's AdaLN
    modulations are computed once, before integrating."""
    b, n = y0.shape[0], y0.shape[1]

    def schedule_fn(times) -> dict:
        return dit.time_mods(torch.as_tensor(times, device=y0.device))

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


def cfm_sample_segmented(
    dit: DiT,
    y0: torch.Tensor,
    step_cond: torch.Tensor,
    text: torch.Tensor,
    mask: torch.Tensor | None,
    ts: np.ndarray,
    cfg_interval: tuple[float, float],
    method: str = "rk4",
    cfg_strength: float = 2.0,
    return_trajectory: bool = True,
) -> torch.Tensor:
    """`cfm_sample_mel` with classifier-free guidance only for the steps
    whose start time lies in [lo, hi] of `cfg_interval`: each run of
    contiguous steps with guidance on or off is one `cfm_sample_mel` call,
    the ones without at `cfg_strength=0.0` (the conditional stream alone,
    batch b instead of 2b). Returns the trajectory [steps, b, n, d] (each
    segment after the first without its duplicate boundary state), or the
    final state [1, b, n, d] when return_trajectory=False."""
    lo, hi = cfg_interval
    active = (ts[:-1] >= lo) & (ts[:-1] <= hi)
    pieces = []
    y_cur = y0
    i = 0
    while i < len(ts) - 1:
        j = i
        while j < len(ts) - 1 and active[j] == active[i]:
            j += 1
        seg = cfm_sample_mel(dit, y_cur, step_cond, text, mask, ts[i:j + 1], method=method,
                             cfg_strength=float(cfg_strength) if active[i] else 0.0,
                             return_trajectory=return_trajectory)
        pieces.append(seg if not pieces else seg[1:])
        y_cur = seg[-1]
        i = j
    # the result is the last segment's end state in both modes: without the
    # trajectory each segment yields only its end state, and the pieces
    # (`seg[1:]`) would then be empty after the first
    return torch.cat(pieces) if return_trajectory else y_cur[None]


def cfm_sample_e2e(
    dit: DiT,
    cond: torch.Tensor,  # [b, padded_len, d] mel, padded to the bucket
    lens: torch.Tensor,  # [b] reference lengths in frames
    duration: torch.Tensor,  # [b] total durations in frames
    max_dur: int | torch.Tensor,  # duration.max(), an int or a 0-d int tensor
    text: torch.Tensor,  # [b, padded_len] int ids padded with -1
    ts: np.ndarray | torch.Tensor,  # [steps] time grid
    y0: torch.Tensor | None,  # [b, n, d] noise, or None to draw from seed
    seed: int,  # ignored when y0 is given
    vocoder: Vocos | None,
    *,
    method: str,
    cfg_strength: float,
    return_trajectory: bool,
    shared_noise: bool,
    cfg_interval: tuple[float, float] | None = None,
):
    """Masks and conditioning -> ODE (`cfm_sample_segmented` with a
    `cfg_interval` on a grid of two points or more, else `cfm_sample_mel`)
    -> composite with the reference -> vocoder at the bucket length with
    `valid_frames=max_dur`. With `ts` a tensor, `max_dur` a 0-d tensor and
    `y0` given, nothing here reads a value on the host, so torch.export
    traces it (export.py); `cfg_interval` needs a numpy grid.

    Returns (mel [b, padded_len, d] zeroed past max_dur, trajectory,
    wave [b, (padded_len - 1) * hop] or None)."""
    cond = cond.float()
    b, padded_len, d = cond.shape
    device = cond.device
    cond_mask = lens_to_mask(lens, padded_len)[..., None]
    step_cond = torch.where(cond_mask, cond, torch.zeros_like(cond))
    dur_mask = lens_to_mask(duration, padded_len)

    if y0 is None:
        y0 = draw_noise(seed, shared_noise, b, padded_len, d, device)
    else:
        y0 = torch.nn.functional.pad(y0.float(), (0, 0, 0, padded_len - y0.shape[1]))
    y0 = y0 * dur_mask[..., None]

    if cfg_interval is None or len(ts) < 2:
        trajectory = cfm_sample_mel(
            dit, y0, step_cond, text, dur_mask, ts, method=method, cfg_strength=cfg_strength,
            return_trajectory=return_trajectory,
        )
    else:
        trajectory = cfm_sample_segmented(
            dit, y0, step_cond, text, dur_mask, ts, cfg_interval, method=method, cfg_strength=cfg_strength,
            return_trajectory=return_trajectory,
        )
    frame_valid = (torch.arange(padded_len, device=device) < max_dur)[None, :, None]
    out = torch.where(cond_mask, cond, trajectory[-1])
    out = torch.where(frame_valid, out, torch.zeros_like(out))
    wave = vocoder.decode(out, valid_frames=max_dur) if vocoder is not None else None
    return out, trajectory, wave


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
        require_dit(dit, "F5TTS (sampling, serving, export)")
        self.dit = dit
        self.dit_cfg = dit_cfg
        self.cfm_cfg = cfm_cfg
        self.audio_cfg = audio_cfg
        self.vocab_char_map = vocab_char_map
        self.vocoder = vocoder
        self.duration_predictor = duration_predictor
        self._cast_cache: tuple | None = None
        self._mesh = None

    @property
    def device(self) -> torch.device:
        return next(self.dit.parameters()).device

    # -- construction ------------------------------------------------------

    @classmethod
    def init(
        cls,
        generator: torch.Generator,
        dit_cfg: DiTConfig = DiTConfig(),
        device: torch.device | str = "cuda",
        **kwargs,
    ) -> "F5TTS":
        """Random weights drawn from `generator`, which must live on `device`."""
        with torch.device(device):
            dit = DiT(dit_cfg)
        init_parameters_(dit, generator)
        return cls(dit, dit_cfg, **kwargs)

    @classmethod
    def from_pretrained(
        cls, local_dir: str | Path, device: torch.device | str = "cuda", quantization_bits: int | None = None,
        expected_sha256: dict[str, str] | None = None,
    ) -> "F5TTS":
        """Load a snapshot directory (see models/convert.py); with
        `quantization_bits` (4 or 8), its weight-only quantized DiT; with
        `expected_sha256` (relative path -> digest), its files verified
        first."""
        from f5_tts_tpu_torch.models.convert import load_f5tts_pretrained

        return load_f5tts_pretrained(local_dir, device, quantization_bits, expected_sha256)

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

    def _mel_spec(self, wave) -> torch.Tensor:
        """Raw wave [b, t] (tensor or array) -> log-mel [b, t // hop, n_mels]
        on the model's device, by its AudioConfig."""
        a = self.audio_cfg
        wave = torch.as_tensor(wave, device=self.device)
        return log_mel_spectrogram(wave, a.sample_rate, a.n_mels, a.n_fft, a.hop_length)

    def _tokenize(self, text: list[str]) -> np.ndarray:
        if self.vocab_char_map is not None:
            return list_str_to_idx(text, self.vocab_char_map)
        return list_str_to_tensor(text)

    def _cast_key(self) -> tuple:
        return (self.dit_cfg.int8_compute, self._mesh,
                tuple((t.data_ptr(), t._version) for t in itertools.chain(self.dit.parameters(), self.dit.buffers())))

    def _cast_dit(self) -> DiT:
        """The master DiT in float32 without `int8_compute`; else a copy cast
        to the compute dtype, then W8A8 with `int8_compute`."""
        if self.dit.compute_dtype == torch.float32 and not self.dit_cfg.int8_compute:
            return self.dit
        dit = copy.deepcopy(self.dit).to(self.dit.compute_dtype)
        return w8a8_blocks_(dit) if self.dit_cfg.int8_compute else dit

    def _inference_dit(self):
        """The DiT the sampler runs. In float32 without `int8_compute`, the
        master DiT. Otherwise a copy is kept: cast to the compute dtype
        (every float tensor, a quantized linear's scales and biases included;
        int8 codes stay), then, with `dit_cfg.int8_compute`, its blocks'
        attention and feed-forward linears re-quantized to W8A8
        (`w8a8_blocks_`, which raises ValueError for a weight-only quantized
        DiT), in that order, as the JAX package casts before it quantizes.
        Under a mesh (`use_mesh`), that DiT split over the grid instead: one
        (`DiTGroup`, vocoder) per data row (`shard_model_for_inference`, and
        a vocoder replica on each row's first device). What is kept is
        rebuilt when the flag or the mesh changes or any parameter or buffer
        is replaced or modified in place. LayerNorm and GRN statistics, the
        timestep sinusoid, the DiT output and the ODE state stay float32 all
        the same."""
        if self._mesh is None and self.dit.compute_dtype == torch.float32 and not self.dit_cfg.int8_compute:
            return self.dit
        key = self._cast_key()
        if self._cast_cache is None or self._cast_cache[0] != key:
            self._cast_cache = None  # drop the old copy before the new one is made
            if self._mesh is None:
                kept = self._cast_dit()
            else:
                groups = shard_model_for_inference(self._cast_dit(), self._mesh)
                kept = [(g, self._vocoder_on(g.device)) for g in groups]
            self._cast_cache = (key, kept)
        return self._cast_cache[1]

    def _vocoder_on(self, device: torch.device) -> Vocos | None:
        """The vocoder, or a copy of it on `device` where it lives elsewhere."""
        if self.vocoder is None or next(self.vocoder.parameters()).device == device:
            return self.vocoder
        return copy.deepcopy(self.vocoder).to(device)

    def use_mesh(self, mesh) -> "F5TTS":
        """Sample over a device grid (parallel/mesh.py `create_mesh`): every
        `sample()` call, in both its branches, pads the batch to a multiple
        of the "data" axis with copies of row 0, draws the noise for the
        padded batch on the model's device, splits the rows over the data
        rows, runs each row's DiT split over its "model" axis (attention
        heads and feed-forward hidden units; `shard_model_for_inference`)
        and a vocoder replica on that row's devices, and returns the
        trimmed result on the model's device. The duration predictor is not
        sharded: it runs on the model's device. The master DiT stays as it
        is; the shards are built here, from the sampler's cast copy. A mesh
        with a "stage" axis (the pipeline's) raises ValueError. Returns
        self."""
        if mesh is not None:
            refuse_stage(mesh, "F5TTS.use_mesh")
        self._mesh = mesh
        self._cast_cache = None
        self._inference_dit()
        return self

    # -- training loss -----------------------------------------------------

    def __call__(self, inp, text, *, lens=None, generator: torch.Generator | None = None,
                 draws: CFMDraws | None = None) -> torch.Tensor:
        """The CFM training loss (`cfm_loss`) of a batch: `inp` is a mel
        [b, n, d] or a raw wave [b, nw], `text` a list of strings or ids
        [b, nt] padded with -1, `lens` the valid frames (default all). It
        runs the master DiT (float32 parameters, compute in the config's
        dtype), never the cast copy that sampling uses."""
        device = self.device
        inp = torch.as_tensor(inp, device=device)
        if inp.ndim == 2:
            inp = self._mel_spec(inp)
        if inp.shape[-1] != self.audio_cfg.n_mels:
            raise ValueError(f"input has {inp.shape[-1]} mel channels, expected {self.audio_cfg.n_mels}")
        batch, seq_len = inp.shape[0], inp.shape[1]
        text_np = np.asarray(self._tokenize(text) if isinstance(text, list) else text, dtype=np.int32)
        if text_np.shape[0] != batch:
            raise ValueError(f"{text_np.shape[0]} texts for a batch of {batch}")
        if text_np.size and int(text_np.max()) >= self.dit_cfg.text_num_embeds:
            raise ValueError(f"text id {int(text_np.max())} out of range for "
                             f"text_num_embeds={self.dit_cfg.text_num_embeds}")
        lens = torch.full((batch,), seq_len, device=device) if lens is None else torch.as_tensor(lens, device=device)
        if generator is None and draws is None:
            generator = torch.Generator(device=device).manual_seed(int(np.random.randint(0, 2**31 - 1)))
        return cfm_loss(self.dit, self.cfm_cfg, inp, torch.as_tensor(text_np, device=device), lens,
                        generator=generator, draws=draws)

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
        cfg_interval: tuple[float, float] | None = None,
        return_trajectory: bool = True,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Zero-shot synthesis.

        Returns (waveform, trajectory), or (mel, trajectory) without a
        vocoder. The output is trimmed to the longest duration; the
        trajectory is [steps, b, n, d] (or the final state [1, b, n, d]).
        `y0` overrides the initial noise; `seed` fixes it, shared by every
        batch row. With `duration=None` the duration predictor sets each
        item's total duration from the reference mel and the text, scaled by
        1 / `speed`. `cfg_interval=(lo, hi)` runs classifier-free guidance
        only for the steps starting at flow times in [lo, hi]; the others
        run the conditional stream alone (`cfm_sample_segmented`)."""
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
            cond = self._mel_spec(cond)
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
        batched = (cond, torch.as_tensor(lens_np, device=device), torch.as_tensor(duration, device=device),
                   torch.as_tensor(text_ids, device=device))
        y0 = None if y0 is None else torch.as_tensor(y0, device=device)
        options = dict(method=method, cfg_strength=float(cfg_strength), return_trajectory=return_trajectory,
                       shared_noise=seed is not None, cfg_interval=cfg_interval)
        ts = sway_time_grid(steps, sway_sampling_coef)
        if self._mesh is None:
            cond, lens_t, dur_t, text_t = batched
            out, trajectory, wave = cfm_sample_e2e(
                self._inference_dit(), cond, lens_t, dur_t, max_dur, text_t, ts, y0, seed_val, self.vocoder, **options)
        else:
            if y0 is None:  # one draw for the padded batch, so that each row gets what it would unsharded
                y0 = draw_noise(seed_val, seed is not None, batch + -batch % self._mesh.shape["data"], padded_len,
                                cond.shape[-1], device)
            rows = self._inference_dit()
            devices = [g.device for g, _ in rows]
            parts = [split_batch(pad_batch(t, len(rows)), devices) for t in (*batched, y0)]
            results = [cfm_sample_e2e(g, c, lens_r, dur_r, max_dur, text_r, ts, y0_r, seed_val, voc, **options)
                       for (g, voc), c, lens_r, dur_r, text_r, y0_r in zip(rows, *parts)]
            out = gather_batch([r[0] for r in results], device, batch)
            trajectory = gather_batch([r[1] for r in results], device, batch, dim=1)
            wave = None if results[0][2] is None else gather_batch([r[2] for r in results], device, batch)
        trajectory = trajectory[:, :, :max_dur]
        if wave is None:
            return out[:, :max_dur], trajectory
        wave = wave[:, : (max_dur - 1) * self.audio_cfg.hop_length]
        if batch == 1:
            wave = wave.reshape(-1)
        return wave, trajectory

