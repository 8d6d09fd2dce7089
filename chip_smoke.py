"""Drive the PyTorch port (f5_tts_tpu_torch) once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: a CUDA device must be present; prints its name and, from
     nvidia-smi, its name and power limit;
  2. build: compiles the attention kernel from the sources in this checkout;
  3. kernel vs plain: the kernel against its plain PyTorch version in bf16 at
     the main path's shape and two edge shapes, timed with CUDA events;
  4. main path: the base DiT (1024 x 22 layers x 16 heads, bf16) and Vocos,
     randomly initialised from a seed, written with save_pretrained and read
     back with from_pretrained, then one warm-up and three requests through
     F5TTS.sample (2 s reference, 10 s total, 32 Euler steps, CFG 2, sway -1);
     checks the waves, the kernel's launch count per request, and one DiT
     forward against the float32 CPU path on a short input.
The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ATTN_TOL = 2e-2  # absolute, on O(1) outputs: both sides round P and the rotated q, k to bf16
DIT_TOL = 3e-2  # relative L2 of a bf16 DiT forward against float32, 22 layers
STEPS = 32
EVALS_PER_REQUEST = STEPS - 1  # Euler: one flow evaluation per step of a 32-point grid
TEXT = ["Some call me nature, others call me mother nature. "
        "This is a benchmark utterance for the flow matching sampler."]
VOCAB_CHARS = [""] + [chr(c) for c in range(ord(" "), ord(" ") + 95)]


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def device_phase():
    import torch

    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    import f5_tts_tpu_torch

    if Path(f5_tts_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: f5_tts_tpu_torch was imported from {f5_tts_tpu_torch.__file__}, "
                         f"not from this checkout ({ROOT})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {smi}")
    return smi.splitlines()[0]


def build_phase():
    from f5_tts_tpu_torch.ops import flash_attention as fa

    phase("build")
    t0 = time.perf_counter()
    lib = fa.build()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    log = (fa.BUILD_DIR / "flash_attention_fwd.build.log")
    if log.exists():
        print(log.read_text().strip())


def _time_ms(fn, iters=20):
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase():
    import torch

    from f5_tts_tpu_torch.models.rope import rotary_freqs
    from f5_tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    phase("kernel vs plain (bf16)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (name, b, h, n, d, valid keys or None, rope, q/k/v as [b, n, h*d] projection views)
    cases = [
        ("main path", 2, 16, 1024, 64, 937, True, True),
        ("ragged n, no mask", 2, 16, 937, 64, None, True, False),
        ("n=4096", 1, 16, 4096, 64, 4000, True, False),
    ]
    results = {}
    for name, b, h, n, d, valid, use_rope, strided in cases:
        def make():
            if strided:
                x = torch.randn(b, n, h * d, generator=gen, device="cuda", dtype=torch.bfloat16)
                return x.view(b, n, h, d).transpose(1, 2)
            return torch.randn(b, h, n, d, generator=gen, device="cuda", dtype=torch.bfloat16)

        q, k, v = make(), make(), make()
        mask = None
        if valid is not None:
            mask = (torch.arange(n, device="cuda") < valid)[None, :].expand(b, n).contiguous()
        rope = None
        if use_rope:
            raw = rotary_freqs(n, d, device="cuda")
            rope = (torch.cos(raw), torch.sin(raw))
        scale = d ** -0.5
        out = flash_attention(q, k, v, scale, key_mask=mask, rope=rope)
        ref = flash_attention_plain(q, k, v, scale, mask, rope)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ms = _time_ms(lambda: flash_attention(q, k, v, scale, key_mask=mask, rope=rope))
        plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v, scale, mask, rope))
        flop = 4 * b * h * n * n * d
        print(f"{name}: [b={b}, h={h}, n={n}, d={d}] mask={valid} rope={use_rope} strided={strided}: "
              f"max|kernel - plain| = {err:.3e} (tol {ATTN_TOL}); kernel {ms:.4f} ms "
              f"({flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
        if not (err <= ATTN_TOL):
            raise AssertionError(f"kernel disagrees with its plain version at {name}: {err}")
        results[name] = (err, ms, plain_ms)
    return results


def main_path_phase(card: str):
    import torch

    from f5_tts_tpu_torch import F5TTS, CFMConfig, Vocos, VocosConfig
    from f5_tts_tpu_torch.config import F5TTS_V1_BASE
    from f5_tts_tpu_torch.ops.flash_attention import flash_attention

    phase("main path: base DiT, bf16, save_pretrained -> from_pretrained -> 1 + 3 requests")
    dit_cfg = F5TTS_V1_BASE.replace(compute_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    src = F5TTS.init(
        gen, dit_cfg, device="cuda", cfm_cfg=CFMConfig(),
        vocab_char_map={c: i for i, c in enumerate(VOCAB_CHARS)},
        vocoder=Vocos.init(gen, VocosConfig(compute_dtype="bfloat16"), device="cuda"),
    )
    n_params = sum(p.numel() for p in src.dit.parameters())
    tmp_base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(dir=tmp_base) as snap:
        src.save_pretrained(snap)
        model = F5TTS.from_pretrained(snap, device="cuda")
    del src
    torch.cuda.synchronize()
    print(f"init + save_pretrained + from_pretrained: {time.perf_counter() - t0:.1f} s; "
          f"DiT parameters: {n_params}")

    sr = model.audio_cfg.sample_rate
    ref = torch.sin(2 * torch.pi * 220 * torch.arange(2 * sr, device="cuda") / sr) * 0.1
    duration = int(10.0 * model.audio_cfg.frames_per_second)
    per_request = dit_cfg.depth * EVALS_PER_REQUEST
    expect_len = (duration - 1) * model.audio_cfg.hop_length

    flash_attention.launches = 0
    times = []
    for i in range(4):
        before = flash_attention.launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave, _ = model.sample(ref[None], TEXT, duration=duration, steps=STEPS, method="euler",
                               cfg_strength=2.0, sway_sampling_coef=-1.0, seed=0,
                               return_trajectory=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = flash_attention.launches - before
        peak = torch.cuda.max_memory_allocated() / 2**30
        label = "warm-up" if i == 0 else f"request {i}"
        print(f"{label}: {wall * 1e3:.1f} ms wall for {wave.shape[-1] / sr:.3f} s of audio "
              f"(RTF {wall / (wave.shape[-1] / sr):.5f}); attention launches {launched}; "
              f"peak memory {peak:.2f} GiB; on {card}")
        if tuple(wave.shape) != (expect_len,):
            raise AssertionError(f"wave shape {tuple(wave.shape)}, expected ({expect_len},)")
        if not torch.isfinite(wave).all() or not (wave != 0).any():
            raise AssertionError("wave is not finite or is all zero")
        if launched != per_request:
            raise AssertionError(f"{launched} attention launches in a request, expected {per_request}")
        if i > 0:
            times.append(wall)
    launches = flash_attention.launches

    phase("DiT forward: bf16 on the card against float32 on the CPU")
    dit_gpu = model._inference_dit()
    dit_cpu = model.dit.to("cpu")
    g = torch.Generator().manual_seed(1)
    b, n = 2, 128
    x, cond = torch.randn(b, n, 100, generator=g), torch.randn(b, n, 100, generator=g)
    text = torch.randint(0, 95, (b, 40), generator=g)
    mask = torch.arange(n)[None, :] < torch.tensor([[n], [100]])
    drop = torch.tensor([False, True])
    outs = []
    for dit, dev in ((dit_gpu, "cuda"), (dit_cpu, "cpu")):
        te = dit.embed_text(text.to(dev), n)
        mods = {k: v[0] for k, v in dit.time_mods(torch.tensor([0.4], device=dev)).items()}
        outs.append(dit(x.to(dev), cond.to(dev), te, mods, drop_audio_cond=drop.to(dev),
                        mask=mask.to(dev)).float().cpu())
    rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
    print(f"relative L2 of the bf16 card forward against float32 CPU: {rel:.3e} (tol {DIT_TOL})")
    if not (rel <= DIT_TOL):
        raise AssertionError(f"DiT forward on the card disagrees with the CPU path: {rel}")
    return times, launches


def main() -> int:
    card = device_phase()
    build_phase()
    kernel = kernel_phase()
    times, launches = main_path_phase(card)
    err, ms, plain_ms = kernel["main path"]
    print(f"requests: {', '.join(f'{t * 1e3:.1f} ms' for t in times)} on {card}")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "f5_tts_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "f5_tts_tpu/ops/flash_attention.py:165",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    import torch

    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
