"""Drive the PyTorch port (f5_tts_tpu_torch) once on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: a CUDA device must be present; prints its name and, from
     nvidia-smi, its name and power limit;
  2. build: compiles every kernel from the sources in this checkout, one nvcc
     per source, all at once;
  3. kernels vs plain, timed with CUDA events: the attention kernel in bf16
     at the main path's shape, the serving phase's (a group of four
     requests with each row's own key mask in both CFG halves, and the
     latency tool's burst) and edge shapes (d 64 and 128 on the
     pre-pass + TMA/wgmma core, d 256 on the mma.sync kernel, a mask
     without RoPE), with the pre-pass's own device time; the attention kernel in
     float32 at the duration predictor's shape and its serving window, the
     duration training shape and the DiT's; the dequantizing matmul at every linear shape of
     the main path, int4 and int8, bf16 and float32, with the float32
     kernel's device time (as in phase 13) at the DiT blocks' shape and at
     the widest time-conditioning shape;
  4. snapshot: the base DiT (1024 x 22 layers x 16 heads, bf16), Vocos and a
     float32 duration predictor (DURATION_V2), randomly initialised from a
     seed, written with save_pretrained as float, int4 and int8 DiT files;
  5. float main path: from_pretrained, then one warm-up and three requests
     through F5TTS.sample (2 s reference, 10 s total, 32 Euler steps, CFG 2,
     sway -1); checks the waves, the kernels' launch counts per request, and
     one DiT forward against the float32 CPU path on a short input;
  6. quantized main path: from_pretrained(quantization_bits=4), the same
     warm-up and three requests, one request with duration=None (the
     float32 predictor, through the float32 attention kernel), the int4 DiT
     forward in bf16 and in float32 on the card (the float32 one through the
     float32 dequantizing matmul and attention kernels, counted) against the
     float32 CPU path, and one int8 load and request;
 6a. W8A8 main path (int8_compute): the W8A8 kernels (quantize_rows and
     rescale_bias in Triton around torch._int_mm) bit for bit against their
     plain versions at the DiT's three linear shapes, a ragged m and m <= 16
     (bf16; float32 at one shape), with device times and the whole linear
     beside bf16 F.linear; int8_probe's lines; then one request through
     generate(int8_compute=True, model=<the float model>) (the caller's
     model left float), and from a snapshot whose config.json sets
     int8_compute one warm-up and three requests in turns with the float
     model's (walls, exact launches: K1 682, quantize_rows and rescale_bias
     4092 each, K3 0; peak memory), the W8A8 mel against the float mel of
     the same noise, a torch.profiler breakdown of one W8A8 request, the
     W8A8 DiT forward on the card against the plain W8A8 forward on the CPU
     (and the CPU's bf16 DiT missing that tolerance), and one /synthesize
     on a W8A8 server;
 6b. mesh inference (parallel/mesh.py), on the float and int4 snapshots: a
     2 x 2 grid (data x model) over distinct cards where there are four,
     else the one card repeated (the slots share its SMs: host cost and
     correctness, not scaling). A batch-3 request (padded to 4; 10, 9.6 and
     9.2 s, the main path's settings) through use_mesh against the same
     request unsharded: walls, peak memory, exact K1 launches (2728) and
     reductions (2728), each row's mel and wave within the served group's
     tolerances, the cfg_interval branch too; the same on the int4 snapshot
     (exact K3 launches), K3 and K3-f32 held to plain at the four shard
     shapes, and one duration=None request (K1-f32 on the grid's first
     device); K1 against plain at a slot's shape [4, 8, 1024, 64] on
     strided views of [4, 1024, 512] projections with each data row's own
     masks, and rescale_bias bit for bit at the column-sharded slot shape
     [2048, 512]; one W8A8 DiT forward under 2 x 2, each data row equal to
     the bit to the unsharded forward of its rows, with the row-parallel
     kernels (row_absmax, quantize_scaled; Triton) bit for bit against
     their plain versions and timed; data 2 alone equal to the bit to the
     unsharded model sampling each data row's rows as a batch of its own,
     and the same distance of a batch of 2 from a batch of 4 taken in
     float32 as a witness; a server over data 2 against an unsharded one
     (one request within 2 LSB; four concurrent requests as one group
     split 2 + 2, each request equal to the bit to the unsharded model
     answering its data row's pair as a group of its own, and its distance
     from the unsharded group of four printed); and the CLI's --mesh-data
     2 over the default devices (on one card, create_mesh's ValueError);
  7. serving, on the float snapshot: the generate CLI in-process twice
     (two sentences through the batched branch, and one sentence with
     --duration 7 --cfg-interval 0.2,0.8; each WAV finite, not silent, of
     the length its durations give), then serve() with warm-ups at 7 s
     (batch 1 and 4), /healthz, four concurrent /synthesize requests of one
     bucket (RK4, 8 steps; grouped, of the expected lengths; the largest
     group's waves and mels held against the same sample call with plain
     attention), a request
     whose duration the float32 predictor sets (K1-f32 launched), a
     3-sentence /synthesize_stream (the first PCM before the end, the
     lengths of its sentences), a malformed request (400), and the
     serve_latency tool's three latencies; K1 launches per group (616);
 7a. export and artifact serving, on the float snapshot: torch.export
     programs (export.py, external weights, the 768-frame bucket) of the
     batch-1 and batch-4 samplers (RK4, 8 steps, CFG 2), the float32
     duration predictor (1024-frame window) and a batch-1 W8A8 sampler
     (Euler, 4 steps), each with its export, save and load seconds, graph
     size and file size; each artifact call held to F5TTS.sample at the
     same seed, steps, method, CFG, sway and bucket (the served group's
     tolerances) with its exact launches (K1 616 a float call with K1's
     plain version made to raise, quantize_rows and rescale_bias 132 a W8A8
     evaluation and K3 0, K1-f32 8 for the duration artifact, which is held
     to the live forward within 1e-4); a fresh process that loads and calls
     the batch-1 artifact with no model module imported and no snapshot file
     opened, its wave equal to this process's to the bit; then
     serve_artifacts over the three float artifacts: /healthz, four
     concurrent /synthesize as one batch-4 call equal to the direct call, a
     request whose duration the duration artifact sets in the batcher thread
     (K1-f32 launched), a 3-sentence stream, a 400, and serve_latency's
     artifact bench (sequential against concurrent utterances/s) beside the
     live server's warm_synthesize_s;
  8. attention backward vs plain, timed with CUDA events: the backward
     kernel in bf16 at the CFM training shape and with a key mask at a
     ragged n, in float32 at the duration training shape, and the forward's
     log-sum-exp output;
  9. CFM training: the base DiT with float32 master weights and bf16
     compute, AdamW and EMA, on a fixed synthetic batch of 4 x 1024 frames
     with fixed draws: one warm-up and eight timed steps (exact attention
     launches per step, a finite falling loss, parameters and EMA moving),
     one grad_accum=2 step, a save_checkpoint / load_checkpoint round trip,
     and the gradient on the card against the float32 CPU path;
 10. duration training: DURATION_V2 in float32 on the same batch shape, a
     few steps with exact float32 attention launches and a falling loss;
 10a. training from a WAV directory: a LibriTTS-layout tree written from
     numpy seed 0 (32 16-bit clips of 2.0 to 9.99 s, a 24-bit and a float32
     clip, and a 16 kHz clip, a file that is not a WAV and an 11 s clip that
     must be dropped) through load_dir -> make_training_pipeline (the
     native decoder, built with g++) into F5TTSTrainer.train (the base DiT,
     bf16 compute, EMA; 6 steps of grad_accum=2 on the on-device mel with the
     step-6 checkpoint, then 2 such steps on the host mel) and
     DurationTrainer.train (DURATION_V2 in float32, host mel, 2 steps):
     exact K1/K2 (K1-f32/K2-f32) launches, finite losses, at least two
     frame buckets, every clip on the native decoder; each run's data wait
     and step wall per step, and one loader_bench line (host CPU rates);
 10b. training over a mesh (models/shard.py `shard_train_state`,
     parallel/mesh.py `shard_train_step`) on a 2 x 2 grid (data x model) of distinct cards
     where there are four, else of the one card repeated: K1 with its lse
     and K2 (bf16 [2, 8, 1024, 64]) and K1-f32 and K2-f32 ([2, 4, 1024, 64])
     against their plain versions on a slot's strided projections, with
     and without the data rows' key masks, and their device times; the base
     DiT (bf16 compute, float32 master, AdamW + EMA, 4 x 1024 frames, fixed
     global draws) sharded against the unsharded trainer from the same
     state: DP x TP 2 steps, FSDP 2 steps, grad_accum=2 1 step (the loss,
     the gradient's relative L2, the share of updates that agree within
     lr / 10, exact K1/K2 launches and collectives, the slots' stored bytes
     and peak memory with and without FSDP, each step's wall beside the
     unsharded step's); the float32 witness (depth 4,
     dropout and remat on) at 2e-5; a sharded trainer's checkpoint loaded
     by an unsharded trainer that continues; the checkpoint manager's
     asynchronous sharded save, latest, and restores over FSDP and without
     EMA; DURATION_V2 (float32) on 2 x 2 at 2e-5; and two ranks over gloo
     on the card (a process each, `parallel.initialize`, the one-slot grid
     of a trainer given no mesh) whose DP step must give one loss, equal to
     the one-process data-2 step's;
 11. probe kernels vs plain, timed with CUDA events: the attention variants
     (attn_pack2, attn_flat, flash_nhd in [b, n, h, d], flash_bhnd_rope; each
     also at a ragged n, and with their device time as in phase 13, the
     RoPE pre-pass's own device time and the host time per call) in bf16,
     with the outputs of P1, P3 and P4 at fixed inputs hashed
     and the Triton LayerNorm + modulate at the probe tools' shapes and at a
     ragged n;
 12. probe tools: both tools' entry points once at their full shapes with
     few repetitions, counting each probe kernel's launches there;
 13. ranking: K3's device time per int4 request (launches per request
     times the kernel's time, summed over the linear shapes), K1's per
     request (682 calls) and per CFM step (22), and K2's per CFM step (22
     calls), each beside the same sum for its library call,
     timed with the card held by a spin kernel while the calls are enqueued
     (so, unlike phases 3 and 8, the host's enqueue is left out); K1-f32's
     and K2-f32's per duration step (8 calls each) beside SDPA float32's,
     and K3-f32's per float32 forward of the int4 DiT (its 166 launches by
     shape) beside F.linear float32's, timed the same way; the host time per wrapper call of K3, K1 and K2 (100
     calls enqueued behind a spin kernel; median, least and most of 10
     runs); and a torch.profiler breakdown of one int4 request, one CFM
     step and one duration step by kernel group.
Phases 1, 2, 4 and 13 alone (device_phase, build_phase, snapshot_phase,
ranking_phase), and phase 11 after phase 1 (probe_kernel_phase), measure
another checkout's package the same way from a copy of this file placed in
its root; `core_hashes` after phase 1 prints the P1, P3 and P4 hashes alone.
Each kernel phase also times one PyTorch call that computes the same
function, where there is one (the library yardstick), and computes the
kernel's bound on this card from its inputs. The line before the last is a
JSON object describing each kernel; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ATTN_TOL = 2e-2  # absolute, on O(1) outputs: both sides round P and the rotated q, k to bf16
QMM_TOL = 2e-2  # absolute, on O(1) outputs: both sides round W to bf16; sums and output rounding differ
# the W8A8 DiT on the card against the plain W8A8 DiT on the CPU, each block fed the card's input to it: the
# outputs' L2 distance over the size of the block's update. On the H100, float32 measured 1.7e-5 to 1.8e-3, the
# CPU's float block (no W8A8) 1.5e-2 to 1.6e-2; bf16 measured 2.3e-2 to 2.7e-2 (bf16 rounds at other places on the
# two sides), the CPU's float block 4.8e-2 to 5.2e-2. The bf16 limit sits between
# the two, near their geometric mean, so that the float block misses it: twice the W8A8 reading would not
W8A8_BLOCK_TOL = {"bfloat16": 3.6e-2, "float32": 4e-3}
# the whole forward's relative L2, 22 layers: bf16 rounds at other places on the two sides; in both, a code next to a
# rounding boundary moves by one (measured 7.1e-3 to 7.3e-3 and 1.4e-3 on the H100; the float DiT reads 7.4e-3 to
# 7.5e-3 and 2.2e-3, so this limit does not tell W8A8 from float: the block limits above do)
W8A8_DIT_TOL = {"bfloat16": 1.5e-2, "float32": 3e-3}
F32_TOL = 1e-4  # absolute, float32 kernels on O(1) outputs: the same math summed in another order
DIT_TOL = 3e-2  # relative L2 of a bf16 DiT forward against float32, 22 layers
DIT_F32_TOL = 1e-4  # relative L2 of a float32 DiT forward on the card against the CPU's: sums in another order
GRAD_TOL = {"bf16": 2e-2, "f32": 1e-4}  # attention backward: max error over the plain gradient's max magnitude
TRAIN_GRAD_TOL = 5e-2  # relative L2 of the DiT's loss gradient, bf16 compute against float32, 22 layers
LN_TOL = (1e-2, 8e-3)  # LayerNorm + modulate, bf16: |kernel - plain| <= a + b |plain| (one output rounding)
TRAIN_BATCH, TRAIN_FRAMES = 4, 1024
TRAIN_LENS = (TRAIN_FRAMES, TRAIN_FRAMES - 24, TRAIN_FRAMES - 100, TRAIN_FRAMES - 217)
# the card's published peaks at 700 W (NVIDIA H100 SXM data sheet, dense). A float32 product to
# float32 accuracy runs fastest on the tensor cores as 3xTF32 (three TF32 products of split operands,
# what the float32 attention kernels do), at a third of the 495 TFLOP/s TF32 rate, above the FMA
# units' 67: that is the float32 bound, so that no tensor-core kernel reads under it.
PEAK_FLOPS = {"bf16": 989e12, "f32": 495e12 / 3, "int8": 1979e12}
PEAK_BYTES = 3.35e12
PROBE_REPS = {"attn_variants": 10, "fusion_probe": 4}
STEPS = 32
EVALS_PER_REQUEST = STEPS - 1  # Euler: one flow evaluation per step of a 32-point grid
TEXT = ["Some call me nature, others call me mother nature. "
        "This is a benchmark utterance for the flow matching sampler."]
VOCAB_CHARS = [""] + [chr(c) for c in range(ord(" "), ord(" ") + 95)]


T_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


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
    from f5_tts_tpu_torch.ops import attn_variants, cuda_build, flash_attention, qmatmul

    phase("build")
    t0 = time.perf_counter()
    sources = (flash_attention.SOURCE, flash_attention.BWD_SOURCE, qmatmul.SOURCE, attn_variants.ROPE_SOURCE)
    if hasattr(attn_variants, "SOURCE"):  # a checkout from before attn_flat moved onto the core
        sources += (attn_variants.SOURCE,)
    libs = cuda_build.build(*sources)
    print(f"built {', '.join(str(lib.relative_to(ROOT)) for lib in libs)} in {time.perf_counter() - t0:.1f} s")
    for src in sources:
        log = cuda_build.log_path(src)
        if log.exists():
            print(log.read_text().strip())


def reset_counts():
    from f5_tts_tpu_torch.ops import w8a8
    from f5_tts_tpu_torch.ops.flash_attention import flash_attention
    from f5_tts_tpu_torch.ops.qmatmul import qmatmul

    flash_attention.launches = flash_attention.launches_f32 = qmatmul.launches = qmatmul.launches_f32 = 0
    flash_attention.launches_bwd = flash_attention.launches_bwd_f32 = 0
    w8a8.quantize_rows.launches = w8a8.rescale_bias.launches = 0
    w8a8.row_absmax.launches = w8a8.quantize_scaled.launches = 0


def counts() -> dict:
    from f5_tts_tpu_torch.ops import w8a8
    from f5_tts_tpu_torch.ops.flash_attention import flash_attention
    from f5_tts_tpu_torch.ops.qmatmul import qmatmul

    return {"flash_attention_fwd": flash_attention.launches,
            "flash_attention_fwd_f32": flash_attention.launches_f32,
            "qmatmul": qmatmul.launches,
            "qmatmul_f32": qmatmul.launches_f32,
            "flash_attention_bwd": flash_attention.launches_bwd,
            "flash_attention_bwd_f32": flash_attention.launches_bwd_f32,
            "w8a8_quantize": w8a8.quantize_rows.launches,
            "w8a8_rescale": w8a8.rescale_bias.launches,
            "w8a8_row_absmax": w8a8.row_absmax.launches,
            "w8a8_quantize_scaled": w8a8.quantize_scaled.launches}


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


def device_ms(fn, iters=20):
    """The device time of one call (`tools/_timing.py` `device_ms`): as
    `_time_ms`, but with the card held by a spin kernel while the host
    enqueues the calls, so a call whose host side is slower than its
    kernels is still timed on the device."""
    from f5_tts_tpu_torch.tools._timing import device_ms

    return device_ms(fn, iters, warmup=3)


def host_us(fn, calls=100, rounds=10) -> list:
    """The host's time to enqueue one call, in us, for each of `rounds` runs
    of `calls` calls enqueued without a synchronize behind a spin kernel (so
    a kernel faster than the host does not change what is timed); sorted."""
    import torch

    from f5_tts_tpu_torch.tools._timing import HOLD_CYCLES

    for _ in range(3):
        fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(per_call)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flop: float, moved: int, peak: str) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it: the
    operations over the peak rate of their type, or the bytes (each input
    read once, each output written once) over the memory rate."""
    by_ops, by_bytes = flop / PEAK_FLOPS[peak] * 1e3, moved / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def _library_line(label: str, what: str, ms: float | None, bound_ms: float, bound_by: str) -> None:
    lib = "none (no single PyTorch call)" if ms is None else f"{ms:.4f} ms ({what})"
    print(f"{label}: library call {lib}; bound {bound_ms * 1e3:.2f} us ({bound_by})")


def _sdpa(q, k, v, scale, mask=None):
    import torch.nn.functional as F

    attn_mask = None if mask is None else mask[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale)


def kernel_phase():
    import torch

    from f5_tts_tpu_torch.models.rope import rotary_freqs
    from f5_tts_tpu_torch.ops import flash_attention as fa
    from f5_tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    phase("kernel vs plain (bf16)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (name, b, h, n, d, valid keys (one count for every row, or one per row) or None, rope, q/k/v as
    # [b, n, h*d] projection views): d 64 and 128 run the pre-pass and the TMA + wgmma core, d 256 the
    # mma.sync kernel. The serving group is the serving phase's four requests of 6 to 7.5 s (562 to 703
    # frames, one 768-frame bucket) in both CFG halves; the burst is the latency tool's three 9 s requests.
    cases = [
        ("main path", 2, 16, 1024, 64, 937, True, True),
        ("serving group", 8, 16, 768, 64, SERVE_FRAMES * 2, True, True),
        ("serving burst", 6, 16, 1024, 64, 843, True, True),
        ("ragged n, no mask", 2, 16, 937, 64, None, True, False),
        ("n=4096", 1, 16, 4096, 64, 4000, True, False),
        ("mask, no RoPE", 2, 16, 1024, 64, 937, False, True),
        ("d=128, ragged n", 2, 8, 1000, 128, 999, True, True),
        ("d=256 (mma.sync)", 1, 8, 1024, 256, 937, True, True),
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
            mask = (torch.arange(n, device="cuda")[None, :]
                    < torch.tensor(valid, device="cuda").reshape(-1, 1)).expand(b, n).contiguous()
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
        if isinstance(valid, tuple):
            # the case tells the rows' masks apart: the plain version with each row given the next row's
            # mask must miss the tolerance
            wrong = flash_attention_plain(q, k, v, scale, mask.roll(1, 0), rope)
            wrong_err = (wrong.float() - ref.float()).abs().max().item()
            print(f"{name}: with each row's mask taken from the next row, max|plain - plain| = {wrong_err:.3e}")
            if not (wrong_err > ATTN_TOL):
                raise AssertionError(f"{name}: the rows' masks give outputs within the tolerance of each other")
        if d in fa.CORE_HEAD_DIMS and (rope is not None or mask is not None):
            # the pre-pass alone against its plain version: the rotation and the biases bit for bit
            key_mask, cos, sin = fa._checked(q, k, v, mask, rope)
            n_pad = -(-n // fa.CORE_ROW_PAD) * fa.CORE_ROW_PAD
            got = fa.flash_prepass(q, k, mask, rope, n_pad)
            want = fa.flash_prepass_plain(q, k, mask, rope, n_pad)
            torch.cuda.synchronize()
            if not all((g is None and w is None) or torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"K1's pre-pass disagrees with its plain version at {name}")
            pre_ms = device_ms(lambda: fa.flash_prepass(q, k, mask, rope, n_pad))
            dev_ms = device_ms(lambda: fa._forward_kernel(q, k, v, scale, key_mask, cos, sin, with_lse=False))
            print(f"{name}: device {dev_ms:.4f} ms, of which the pre-pass alone {pre_ms:.4f} ms "
                  f"(its outputs equal to the plain pre-pass's)")
        results[name] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                         **_attention_yardstick(name, q, k, v, scale, mask, rope, "bf16")}
    return results


def _attention_yardstick(label, q, k, v, scale, mask, rope, peak) -> dict:
    """SDPA on q and k already rotated, with the same key mask (the rotation
    is not timed), and the forward's bound: 4 h n d operations for each key
    the mask keeps in each row, q, k, v and the output, the mask and the
    tables moved once."""
    from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb

    b, h, n, d = q.shape
    qr, kr = (q, k) if rope is None else (apply_rotary_pos_emb(q, rope), apply_rotary_pos_emb(k, rope))
    library_ms = _time_ms(lambda: _sdpa(qr, kr, v, scale, mask))
    keys = b * n if mask is None else int(mask.sum())
    bound_ms, bound_by = bound(4 * h * n * keys * d,
                               nbytes(q, k, v, q, mask, *(rope or ())), peak)
    _library_line(label, "SDPA, RoPE outside" if rope is not None else "SDPA", library_ms, bound_ms, bound_by)
    return {"library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def f32_attention_phase():
    import torch

    from f5_tts_tpu_torch.models.rope import rotary_freqs
    from f5_tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    phase("attention kernel vs plain (float32)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    # (name, b, h, n, d, valid keys or None): q, k, v as [b, n, h*d] projection views, RoPE. The serving
    # window is the predictor's input in the server: the bundled clip's 499 frames padded to 512.
    cases = [("duration predictor", 1, 8, 187, 64, None),
             ("predictor serving window", 1, 8, 512, 64, None),
             ("duration training", TRAIN_BATCH, 8, TRAIN_FRAMES, 64, None),
             ("DiT shape", 2, 16, 1024, 64, 937)]
    results = {}
    for name, b, h, n, d, valid in cases:
        x = [torch.randn(b, n, h * d, generator=gen, device="cuda") for _ in range(3)]
        q, k, v = (t.view(b, n, h, d).transpose(1, 2) for t in x)
        mask = None
        if valid is not None:
            mask = (torch.arange(n, device="cuda") < valid)[None, :].expand(b, n).contiguous()
        raw = rotary_freqs(n, d, device="cuda")
        rope = (torch.cos(raw), torch.sin(raw))
        scale = d ** -0.5
        out = flash_attention(q, k, v, scale, key_mask=mask, rope=rope)
        ref = flash_attention_plain(q, k, v, scale, mask, rope)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ms = _time_ms(lambda: flash_attention(q, k, v, scale, key_mask=mask, rope=rope))
        plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v, scale, mask, rope))
        print(f"{name}: [b={b}, h={h}, n={n}, d={d}] mask={valid} rope=True float32: "
              f"max|kernel - plain| = {err:.3e} (tol {F32_TOL}); kernel {ms:.4f} ms "
              f"({4 * b * h * n * n * d / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms")
        if not (err <= F32_TOL):
            raise AssertionError(f"float32 attention kernel disagrees with its plain version at {name}: {err}")
        results[name] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                         **_attention_yardstick(name, q, k, v, scale, mask, rope, "f32")}
    return results


# (linear, m, k, n) of every quantized linear on the main path: time
# conditioning over the 31 evaluation times, the text branch over 1024
# padded text positions, the DiT blocks over 2 x 1024 frames (CFG)
QMM_SHAPES = [
    ("time_mlp.0", 31, 256, 1024), ("time_mlp.2", 31, 1024, 1024),
    ("attn_norm.linear", 31, 1024, 6144), ("norm_out.linear", 31, 1024, 2048),
    ("text pwconv1", 1024, 512, 1024), ("text pwconv2", 1024, 1024, 512),
    ("to_q/k/v/out", 2048, 1024, 1024), ("ff w1", 2048, 1024, 2048), ("ff w2", 2048, 2048, 1024),
    ("proj_out", 2048, 1024, 100),
]


# the float32 rows whose device time the quantized phase prints: the DiT blocks' linears, the widest m = 31 one
QMM_F32_DEVICE_SHAPES = ((2048, 1024, 1024), (31, 1024, 6144))


def qmatmul_phase():
    import numpy as np
    import torch

    from f5_tts_tpu_torch.models.quant import quantize_kernel
    from f5_tts_tpu_torch.ops.qmatmul import dequantize_kernel, qmatmul, qmatmul_plain

    phase("dequantizing matmul vs plain (int4 and int8, bf16 and float32)")
    rng = np.random.default_rng(0)
    results = {}
    for name, m, k, n in QMM_SHAPES:
        # drawn as the model's linears are, so outputs stay O(1)
        w = (rng.uniform(-1, 1, (k, n)) / np.sqrt(k)).astype(np.float32)
        bias = torch.tensor(rng.standard_normal(n).astype(np.float32) * 0.1, device="cuda")
        x32 = torch.tensor(rng.standard_normal((m, k)).astype(np.float32), device="cuda")
        for bits in (4, 8):
            p = quantize_kernel(w, bits)
            q, s32, b32 = (torch.from_numpy(np.ascontiguousarray(p[t].T)).cuda() for t in ("q", "scales", "biases"))
            for dtype, tol in ((torch.bfloat16, QMM_TOL), (torch.float32, F32_TOL)):
                # scales, biases and bias in the activations' dtype, as the cast model holds them
                x, s, b, bb = (t.to(dtype) for t in (x32, s32, b32, bias))
                out = qmatmul(x, q, s, b, bb)
                ref = qmatmul_plain(x, q, s, b, bb)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ms = _time_ms(lambda: qmatmul(x, q, s, b, bb))
                plain_ms = _time_ms(lambda: qmatmul_plain(x, q, s, b, bb))
                label = f"{name} [m={m}, k={k}, n={n}] int{bits} {str(dtype).removeprefix('torch.')}"
                print(f"{label}: max|kernel - plain| = {err:.3e} (tol {tol}); kernel {ms:.4f} ms "
                      f"({2 * m * k * n / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms")
                if not (err <= tol):
                    raise AssertionError(f"dequantizing matmul disagrees with its plain version at {label}: {err}")
                # yardstick: one matmul on the weight already dequantized; bound: 2 m k n
                # operations, x, the int8 codes, scales, biases, bias and the output moved once
                w_deq = dequantize_kernel(q, s, b).to(dtype)
                library_ms = _time_ms(lambda: torch.nn.functional.linear(x, w_deq, bb))
                bound_ms, bound_by = bound(2 * m * k * n, nbytes(x, q, s, b, bb, out),
                                           "bf16" if dtype == torch.bfloat16 else "f32")
                _library_line(label, "F.linear, no dequantization", library_ms, bound_ms, bound_by)
                if dtype == torch.float32 and (m, k, n) in QMM_F32_DEVICE_SHAPES:
                    print(f"{label}: device {device_ms(lambda: qmatmul(x, q, s, b, bb)):.4f} ms, F.linear float32 "
                          f"device {device_ms(lambda: torch.nn.functional.linear(x, w_deq, bb)):.4f} ms")
                results[(name, bits, dtype)] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                                                "library_ms": library_ms, "bound_ms": bound_ms,
                                                "bound_by": bound_by}
    return results


def snapshot_phase(snap: str):
    import torch

    from f5_tts_tpu_torch import F5TTS, CFMConfig, Vocos, VocosConfig
    from f5_tts_tpu_torch.config import DURATION_V2, F5TTS_V1_BASE
    from f5_tts_tpu_torch.models.duration import DurationPredictor

    phase("snapshot: base DiT + Vocos + float32 duration predictor -> save_pretrained (float, int4, int8)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    src = F5TTS.init(
        gen, F5TTS_V1_BASE.replace(compute_dtype="bfloat16"), device="cuda", cfm_cfg=CFMConfig(),
        vocab_char_map={c: i for i, c in enumerate(VOCAB_CHARS)},
        vocoder=Vocos.init(gen, VocosConfig(compute_dtype="bfloat16"), device="cuda"),
        duration_predictor=DurationPredictor.init(gen, DURATION_V2, device="cuda"),
    )
    n_params = sum(p.numel() for p in src.dit.parameters())
    src.save_pretrained(snap)
    t1 = time.perf_counter()
    for bits in (4, 8):
        src.save_pretrained(snap, quantization_bits=bits)
    print(f"init + save_pretrained: {t1 - t0:.1f} s; quantize + save int4 and int8: "
          f"{time.perf_counter() - t1:.1f} s; DiT parameters: {n_params}; files: "
          + ", ".join(f"{f.name} {f.stat().st_size / 2**20:.1f} MiB" for f in sorted(Path(snap).glob("*.safetensors"))))


ZERO = {"flash_attention_fwd": 0, "flash_attention_fwd_f32": 0, "qmatmul": 0, "qmatmul_f32": 0,
        "flash_attention_bwd": 0, "flash_attention_bwd_f32": 0, "w8a8_quantize": 0, "w8a8_rescale": 0,
        "w8a8_row_absmax": 0, "w8a8_quantize_scaled": 0}


def _request(model, ref, duration, card: str, label: str, expect: dict, expect_len: int) -> float:
    """One request; checks the wave and each kernel's launches in it against
    `expect`. Returns its wall time."""
    import torch

    before = counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wave, _ = model.sample(ref[None], TEXT, duration=duration, steps=STEPS, method="euler",
                           cfg_strength=2.0, sway_sampling_coef=-1.0, seed=0, return_trajectory=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in counts().items()}
    sr = model.audio_cfg.sample_rate
    print(f"{label}: {wall * 1e3:.1f} ms wall for {wave.shape[-1] / sr:.3f} s of audio "
          f"(RTF {wall / (wave.shape[-1] / sr):.5f}); launches {launched}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
    if tuple(wave.shape) != (expect_len,):
        raise AssertionError(f"wave shape {tuple(wave.shape)}, expected ({expect_len},)")
    if not torch.isfinite(wave).all() or not (wave != 0).any():
        raise AssertionError("wave is not finite or is all zero")
    if launched != expect:
        raise AssertionError(f"kernel launches in the request {launched}, expected {expect}")
    return wall


def _dit_inputs():
    """`_dit_out`'s input on the CPU: 2 x 128 frames, the second row 100
    valid and its audio condition dropped, 40 text ids, flow time 0.4."""
    import torch

    g = torch.Generator().manual_seed(1)
    b, n = 2, 128
    x, cond = torch.randn(b, n, 100, generator=g), torch.randn(b, n, 100, generator=g)
    text = torch.randint(0, 95, (b, 40), generator=g)
    mask = torch.arange(n)[None, :] < torch.tensor([[n], [100]])
    return x, cond, text, mask, torch.tensor([False, True]), torch.tensor([0.4])


def _dit_out(dit, dev: str):
    """One DiT forward on `dev` on `_dit_inputs`, as float32 on the CPU."""
    import torch

    x, cond, text, mask, drop, t = _dit_inputs()
    with torch.no_grad():
        te = dit.embed_text(text.to(dev), x.shape[1])
        mods = {k: v[0] for k, v in dit.time_mods(t.to(dev)).items()}
        return dit(x.to(dev), cond.to(dev), te, mods, drop_audio_cond=drop.to(dev), mask=mask.to(dev)).float().cpu()


def _dit_forward_check(model, label: str) -> None:
    """The model's DiT in bf16 on the card against float32 on the CPU (which
    the CPU tests hold to the JAX package); moves model.dit to the CPU."""
    phase(f"DiT forward ({label}): bf16 on the card against float32 on the CPU")
    dit_gpu = model._inference_dit()
    outs = [_dit_out(dit_gpu, "cuda"), _dit_out(model.dit.to("cpu"), "cpu")]
    rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
    print(f"relative L2 of the bf16 card forward against float32 CPU: {rel:.3e} (tol {DIT_TOL})")
    if not (rel <= DIT_TOL):
        raise AssertionError(f"DiT forward ({label}) on the card disagrees with the CPU path: {rel}")


def _setup(model):
    import torch

    sr = model.audio_cfg.sample_rate
    ref = torch.sin(2 * torch.pi * 220 * torch.arange(2 * sr, device="cuda") / sr) * 0.1
    duration = int(10.0 * model.audio_cfg.frames_per_second)
    return ref, duration, (duration - 1) * model.audio_cfg.hop_length


def _dit_f32_check(model) -> dict:
    """The model's quantized DiT in float32 on the card (the float32
    dequantizing matmul and attention kernels) against float32 on the CPU,
    on `_dit_out`'s input; returns the kernel launches of the card forward,
    which must be one K3 per quantized linear and one K1-f32 per block."""
    import torch

    from f5_tts_tpu_torch.models.dit import DiT
    from f5_tts_tpu_torch.models.quant import QuantizedLinear, quantize_module_

    phase("DiT forward (int4, float32): the quantized DiT in float32 on the card against the CPU")
    cfg = model.dit_cfg.replace(compute_dtype="float32")
    dits = {}
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            dits[dev] = quantize_module_(DiT(cfg), None)
        dits[dev].load_state_dict(model.dit.state_dict())
    reset_counts()
    outs = [_dit_out(dits["cuda"], "cuda")]
    launched = counts()
    outs.append(_dit_out(dits["cpu"], "cpu"))
    expect = {**ZERO, "flash_attention_fwd_f32": cfg.depth,
              "qmatmul_f32": sum(isinstance(m, QuantizedLinear) for m in dits["cuda"].modules())}
    rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
    print(f"relative L2 of the float32 card forward against float32 CPU: {rel:.3e} (tol {DIT_F32_TOL}); "
          f"launches {launched}")
    if not (rel <= DIT_F32_TOL):
        raise AssertionError(f"the float32 int4 DiT forward on the card disagrees with the CPU path: {rel}")
    if launched != expect:
        raise AssertionError(f"float32 DiT forward: kernel launches {launched}, expected {expect}")
    if sum(dit_f32_launches_by_shape(cfg).values()) != expect["qmatmul_f32"]:
        raise AssertionError(f"the ranking phase's K3-f32 shapes {dit_f32_launches_by_shape(cfg)} do not sum to the "
                             f"forward's {expect['qmatmul_f32']} launches")
    return launched


def float_path_phase(card: str, snap: str):
    import torch

    from f5_tts_tpu_torch import F5TTS

    phase("float main path: from_pretrained -> 1 + 3 requests")
    t0 = time.perf_counter()
    model = F5TTS.from_pretrained(snap, device="cuda")
    torch.cuda.synchronize()
    print(f"from_pretrained: {time.perf_counter() - t0:.1f} s")
    ref, duration, expect_len = _setup(model)
    per_request = {**ZERO, "flash_attention_fwd": model.dit_cfg.depth * EVALS_PER_REQUEST}
    reset_counts()
    times = [_request(model, ref, duration, card, "warm-up" if i == 0 else f"request {i}", per_request, expect_len)
             for i in range(4)][1:]
    launched = counts()
    _dit_forward_check(model, "float")
    return times, launched


def qmm_launches_per_request(cfg) -> int:
    """Quantized-linear launches in one request: the time conditioning once
    (time MLP 2, one AdaLN linear per block, norm_out), the text branch for
    the two CFG embeddings (2 per ConvNeXt block each), and per flow
    evaluation 6 per block (q, k, v, out, two FF) plus proj_out."""
    return (2 + cfg.depth + 1) + 2 * 2 * cfg.conv_layers + EVALS_PER_REQUEST * (6 * cfg.depth + 1)


def qmm_launches_by_shape(cfg) -> dict:
    """The quantized-linear launches of one request by `QMM_SHAPES` name;
    they sum to `qmm_launches_per_request`."""
    evals, depth, conv = EVALS_PER_REQUEST, cfg.depth, cfg.conv_layers
    return {"time_mlp.0": 1, "time_mlp.2": 1, "attn_norm.linear": depth, "norm_out.linear": 1,
            "text pwconv1": 2 * conv, "text pwconv2": 2 * conv, "to_q/k/v/out": evals * 4 * depth,
            "ff w1": evals * depth, "ff w2": evals * depth, "proj_out": evals}


def quantized_path_phase(card: str, snap: str):
    import numpy as np
    import torch

    from f5_tts_tpu_torch import F5TTS
    from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram
    from f5_tts_tpu_torch.models.cfm import clamp_duration
    from f5_tts_tpu_torch.ops import qmatmul as qm

    phase("quantized main path: from_pretrained(quantization_bits=4) -> 1 + 3 requests, duration=None")
    t0 = time.perf_counter()
    model = F5TTS.from_pretrained(snap, device="cuda", quantization_bits=4)
    torch.cuda.synchronize()
    print(f"from_pretrained(quantization_bits=4): {time.perf_counter() - t0:.1f} s; "
          f"duration predictor {model.duration_predictor.cfg}")
    ref, duration, expect_len = _setup(model)
    cfg = model.dit_cfg
    per_request = {**ZERO, "flash_attention_fwd": cfg.depth * EVALS_PER_REQUEST,
                   "qmatmul": qmm_launches_per_request(cfg)}
    print(f"expected per request: {per_request}")

    # the predictor's duration for this request, worked out before the counted run
    a = model.audio_cfg
    mel = log_mel_spectrogram(ref, a.sample_rate, a.n_mels, a.n_fft, a.hop_length)
    ids = model._tokenize(TEXT)
    predicted = model.predict_duration(mel, ids)
    clamped = int(clamp_duration(predicted, np.array([mel.shape[1]]), np.array([ids.shape[1]]),
                                 model.cfm_cfg.max_duration)[0])
    print(f"predicted duration {int(predicted[0])} frames, clamped {clamped}")

    reset_counts()
    maps = [qm.maps_encoded()]
    times = []
    for i in range(4):
        times.append(_request(model, ref, duration, card, "warm-up" if i == 0 else f"request {i}", per_request,
                              expect_len))
        maps.append(qm.maps_encoded())
    times = times[1:]
    # K3 keeps its TMA maps by address and shape: the requests after the warm-up encode no codes map and no
    # more x maps than the warm-up did (a miss on every launch would encode three times as many)
    first, later = ({k: b[k] - a[k] for k in a} for a, b in ((maps[0], maps[1]), (maps[1], maps[4])))
    print(f"K3 tensor maps encoded: warm-up request {first}; the three requests after it {later}, "
          f"over {3 * per_request['qmatmul']} launches")
    if later["codes"] or later["x"] > first["x"]:
        raise AssertionError(f"K3 re-encodes its tensor maps: warm-up {first}, the three requests after it {later}")
    with_predictor = {**per_request, "flash_attention_fwd_f32": model.duration_predictor.cfg.depth}
    _request(model, ref, None, card, "request with duration=None", with_predictor, (clamped - 1) * a.hop_length)
    launched = counts()
    launched = {k: v + launched[k] for k, v in _dit_f32_check(model).items()}
    _dit_forward_check(model, "int4")
    del model

    phase("int8 path: from_pretrained(quantization_bits=8) -> 1 request")
    reset_counts()
    model8 = F5TTS.from_pretrained(snap, device="cuda", quantization_bits=8)
    _request(model8, ref, duration, card, "int8 request", per_request, expect_len)
    launched = {k: v + launched[k] for k, v in counts().items()}
    return times, launched


# ------------------------------------------------------------ 6b. mesh inference

MESH = {"data": 2, "model": 2}
MESH_TEXTS = [TEXT[0], "A second request, shorter than the first one.", "And a third."]
MESH_FRAMES = (937, 900, 860)  # per-item durations in one 1024-frame bucket: 10 s, 9.6 s, 9.2 s
SHARD_M = 2 * 2 * 1024  # K3's and the W8A8 row kernels' rows on a slot: CFG x 2 rows a data row x 1024 frames
# (label, k, n) of the DiT's quantized linears on a slot of a model axis of 2
SHARD_SHAPES = (("to_q/k/v", 1024, 512), ("to_out", 512, 1024), ("ff w1", 1024, 1024), ("ff w2", 1024, 1024))
DP_FRAMES = (650, 703, 562, 703)  # two data rows whose longest is the group's: each pads and trims as the group
# one served request, sharded against unsharded: the JAX suite's tolerance (tests/test_mesh_serving.py)
MESH_PCM_LSB = 2
# the served group of four: 562, 703, 703 and 703 frames in one 768-frame bucket, so that however the batcher orders
# the group, each data row's pair holds the group's longest request and pads and trims as the group
MESH_SERVE_DURATIONS = (6.0, 7.5, 7.5, 7.5)


def mesh_devices() -> list:
    """The grid's devices: distinct cards where the machine has data x model
    of them, else the one card repeated (a virtual grid, as the JAX suite
    meshes virtual CPU devices)."""
    import torch

    n = MESH["data"] * MESH["model"]
    return None if torch.cuda.device_count() >= n else ["cuda:0"] * n


def mesh_qmm_launches(cfg, data: int, model: int) -> int:
    """K3 launches in one request over a data x model grid: each data row
    computes the time conditioning and the two text embeddings once, on its
    first slot, and each slot its blocks' six linears and proj_out per flow
    evaluation."""
    return data * ((2 + cfg.depth + 1) + 2 * 2 * cfg.conv_layers + model * EVALS_PER_REQUEST * (6 * cfg.depth + 1))


def _rows_rel_l2(got: tuple, want: tuple, lens, durations, hop) -> dict:
    """The largest relative L2 over the rows of the generated mel frames
    (the final ODE state) and wave samples of two sample() outputs."""
    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    (wave, traj), (want_wave, want_traj) = got, want
    rows = list(enumerate(zip(lens, durations)))
    return {"mel": max(rel(traj[0, i, r:d], want_traj[0, i, r:d]) for i, (r, d) in rows),
            "wave": max(rel(wave[i, r * hop:(d - 1) * hop], want_wave[i, r * hop:(d - 1) * hop]) for i, (r, d) in rows)}


def _mesh_request(model, label: str, card: str, expect: dict, reductions: dict | None, **kw) -> tuple:
    """One batch-3 request (the main path's settings, per-item durations)
    with its launches and reductions checked; returns (wave, traj, wall)."""
    import numpy as np
    import torch

    from f5_tts_tpu_torch.parallel.mesh import all_reduce

    ref, _, _ = _setup(model)
    a = model.audio_cfg
    cond = log_mel(model, ref).expand(len(MESH_TEXTS), -1, -1)
    before, red_before = counts(), dict(all_reduce.counts)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wave, traj = model.sample(cond, MESH_TEXTS, duration=np.array(MESH_FRAMES), steps=STEPS, method="euler",
                              cfg_strength=2.0, sway_sampling_coef=-1.0, seed=0, return_trajectory=False, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in counts().items()}
    reduced = {k: v - red_before[k] for k, v in all_reduce.counts.items()}
    print(f"{label}: {wall * 1e3:.1f} ms wall for 3 x {max(MESH_FRAMES) / a.frames_per_second:.3f} s; launches "
          f"{launched}; reductions {reduced}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"on {card}", flush=True)
    if tuple(wave.shape) != (3, (max(MESH_FRAMES) - 1) * a.hop_length) or not torch.isfinite(wave).all():
        raise AssertionError(f"{label}: wave {tuple(wave.shape)}, or not finite")
    if launched != expect or (reductions is not None and reduced != reductions):
        raise AssertionError(f"{label}: launches {launched}, reductions {reduced}; expected {expect}, {reductions}")
    return wave, traj, wall


def log_mel(model, wave):
    from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram

    a = model.audio_cfg
    return log_mel_spectrogram(wave[None], a.sample_rate, a.n_mels, a.n_fft, a.hop_length)


def _held(label: str, got: tuple, want: tuple, model) -> None:
    ref, _, _ = _setup(model)
    lens = [log_mel(model, ref).shape[1]] * len(MESH_FRAMES)
    errs = _rows_rel_l2(got, want, lens, MESH_FRAMES, model.audio_cfg.hop_length)
    print(f"{label} against unsharded: largest relative L2 of a row's generated mel {errs['mel']:.3e}, wave "
          f"{errs['wave']:.3e} (tol {SERVE_TOL})")
    if not all(errs[x] <= SERVE_TOL[x] for x in SERVE_TOL):
        raise AssertionError(f"{label}: the sharded sample disagrees with the unsharded one: {errs}")


def _pcm(body: bytes):
    import numpy as np

    return np.frombuffer(body[44:], dtype="<i2").astype(np.int32)


def _served_pcm(model, label: str, card: str) -> dict:
    """After a warm-up at batch 1 and 4: one /synthesize request (the JAX
    suite's check: batch 1, so each data row of a mesh samples one row as
    the unsharded server does) and four concurrent requests of one bucket
    (MESH_SERVE_DURATIONS, RK4 at SERVE_STEPS). Returns {"single": PCM,
    "group": PCM by request text, "sizes": group sizes of the concurrent
    four, "groups": those groups' requests in the batcher's order}."""
    import threading

    from f5_tts_tpu_torch.serve import serve, warmup

    def payload(sec, i=None):
        number = "" if i is None else f", number {i}"
        return {"text": f"A request of {sec} seconds in all{number}.", "duration": sec, "steps": SERVE_STEPS,
                "method": "rk4", "seed": 0}

    httpd = serve(model, "127.0.0.1", 0, max_batch=4, max_wait_ms=500)
    port, groups, bodies, errors, out = httpd.server_address[1], [], {}, [], {}
    try:
        warmup(model, [7.0], steps=SERVE_STEPS, method="rk4", batch_sizes=(1, 4), batcher=httpd.batcher)
        out["single"] = _pcm(_ok(port, payload(7.0), f"{label} single request"))
        run_group = httpd.batcher._run_group

        def recording(group):
            groups.append(list(group))
            run_group(group)

        httpd.batcher._run_group = recording

        def hit(i, sec):
            try:
                body = payload(sec, i)
                bodies[body["text"]] = _ok(port, body, f"{label} {sec} s")
            except Exception as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=hit, args=item) for item in enumerate(MESH_SERVE_DURATIONS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors or len(bodies) != len(MESH_SERVE_DURATIONS):
            raise AssertionError(f"{label}: concurrent requests failed: {errors}")
        out["groups"], out["sizes"] = groups, [len(g) for g in groups]
    finally:
        httpd.batcher.stop()
        httpd.shutdown()
        httpd.batcher.join(timeout=60)
    print(f"{label}: 4 concurrent requests {wall:.3f} s, group sizes {out['sizes']}; on {card}", flush=True)
    out["group"] = {text: _pcm(body) for text, body in bodies.items()}
    return out


class _Pairwise:
    """An unsharded model that samples each data row's half of a batch as a
    batch of its own and joins the halves, as a mesh over data rows
    samples them; anything else is the model's."""

    def __init__(self, model):
        self.model = model

    def __getattr__(self, name):
        return getattr(self.model, name)

    def sample(self, cond, text, duration, lens, **kw):
        import torch

        half = len(duration) // MESH["data"]
        rows = [slice(r * half, (r + 1) * half) for r in range(MESH["data"])]
        parts = [self.model.sample(cond[r], text[r], duration=duration[r], lens=lens[r], **kw) for r in rows]
        return torch.cat([p[0] for p in parts]), None


def _pairs_pcm(model, group: list) -> dict:
    """What the unsharded `model` answers for a served group (its requests
    in the batcher's order) through the batcher's group path (one reference
    mel for the group, tokens, durations, trimming), each data row's half
    sampled as a batch of its own: PCM by request text."""
    from concurrent.futures import Future

    import numpy as np
    import torch

    from f5_tts_tpu_torch.serve import MicroBatcher, _pcm16

    reqs = [dataclasses.replace(q, future=Future(), counted=False) for q in group]
    with torch.inference_mode():
        MicroBatcher(_Pairwise(model))._run_group(reqs)
    return {q.text: np.frombuffer(_pcm16(q.future.result()), dtype="<i2").astype(np.int32) for q in reqs}


def _pcm_apart(a: dict, b: dict) -> tuple[int, float]:
    """(the largest |difference| in LSB, the largest relative L2 of a
    request) between two sets of PCM answers by duration."""
    import numpy as np

    lsb = max(int(np.abs(a[s] - b[s]).max()) for s in a)
    rel = max(float(np.linalg.norm(a[s] - b[s]) / np.linalg.norm(b[s])) for s in a)
    return lsb, rel


def _slot_kernel_checks() -> None:
    """K1 bf16 at a slot's shape on the 2 x 2 mesh path against its plain
    version: [2 rows x CFG, 16 / model heads, 1024, 64] on strided views
    of the slot's [4, 1024, 512] projections, with each data row's own key
    masks (its rows' durations in both CFG halves; the padded batch's last
    row is a copy of row 0). Then N2's rescale_bias bit for bit at the
    column-sharded linears' slot shape of the W8A8 2 x 2 forward,
    [2 x 1024, 1024 / model]."""
    import torch

    from f5_tts_tpu_torch.models.rope import rotary_freqs
    from f5_tts_tpu_torch.ops import w8a8 as W
    from f5_tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(31)
    h, n, d = 16 // MESH["model"], 1024, 64
    padded = MESH_FRAMES + MESH_FRAMES[:1] * (-len(MESH_FRAMES) % MESH["data"])
    per_row = len(padded) // MESH["data"]
    raw = rotary_freqs(n, d, device="cuda")
    rope, scale = (torch.cos(raw), torch.sin(raw)), d ** -0.5
    for r in range(MESH["data"]):
        valid = padded[r * per_row:(r + 1) * per_row] * 2  # the conditioned and the unconditioned half
        b = len(valid)
        q, k, v = (torch.randn(b, n, h * d, generator=gen, device="cuda", dtype=torch.bfloat16)
                   .view(b, n, h, d).transpose(1, 2) for _ in range(3))
        mask = torch.arange(n, device="cuda")[None, :] < torch.tensor(valid, device="cuda")[:, None]
        out = flash_attention(q, k, v, scale, key_mask=mask, rope=rope)
        err = (out.float() - flash_attention_plain(q, k, v, scale, mask, rope).float()).abs().max().item()
        ms = _time_ms(lambda: flash_attention(q, k, v, scale, key_mask=mask, rope=rope))
        plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v, scale, mask, rope))
        print(f"K1 bf16 at data row {r}'s slot shape [b={b}, h={h}, n={n}, d={d}] on strided views of "
              f"[{b}, {n}, {h * d}] projections (strides {q.stride()}), masks {valid}: max |kernel - plain| "
              f"{err:.3e} (tol {ATTN_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= ATTN_TOL:
            raise AssertionError(f"K1 at data row {r}'s slot shape disagrees with its plain version: {err}")

    m, k_in, n_out = 2 * 1024, 1024, 1024 // MESH["model"]
    codes, sx = W.quantize_rows_plain(torch.randn(m, k_in, generator=gen, device="cuda").to(torch.bfloat16))
    w8, w_scale = W.quantize_rows_plain(torch.randn(n_out, k_in, generator=gen, device="cuda") / k_in ** 0.5)
    acc = W.int8_product_plain(codes, w8)
    bias = (0.1 * torch.randn(n_out, generator=gen, device="cuda")).to(torch.bfloat16)
    y = W.rescale_bias(acc, sx, w_scale, bias, torch.bfloat16)
    want = W.rescale_bias_plain(acc, sx, w_scale, bias, torch.bfloat16)
    err = (y.float() - want.float()).abs().max().item()
    ms = _time_ms(lambda: W.rescale_bias(acc, sx, w_scale, bias, torch.bfloat16))
    plain_ms = _time_ms(lambda: W.rescale_bias_plain(acc, sx, w_scale, bias, torch.bfloat16))
    print(f"rescale_bias at the column-sharded slot shape [m={m}, n={n_out}] bfloat16: max |kernel - plain| "
          f"{err:.3e}, bit for bit: {'yes' if torch.equal(y, want) else 'NO'}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    if not torch.equal(y, want):
        raise AssertionError(f"rescale_bias at the column-sharded slot shape disagrees with its plain version: {err}")


def mesh_phase(card: str, snap: str) -> tuple[dict, dict]:
    """Mesh inference on a 2 x 2 grid (data x model): the float base DiT
    and the int4 snapshot through use_mesh against the same requests
    unsharded, the cfg_interval branch, a duration=None request, K3 at the
    shard shapes, a W8A8 DiT forward to the bit with its row kernels, a
    served group split over data 2 against an unsharded server, and the
    CLI's --mesh-data 2 over the default devices. Returns the launches of
    the phase's sharded requests and forwards, and the W8A8 row kernels'
    results for the kernels line."""
    import numpy as np
    import torch

    from f5_tts_tpu_torch import F5TTS
    from f5_tts_tpu_torch import generate as gen
    from f5_tts_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain
    from f5_tts_tpu_torch.parallel.mesh import all_reduce, create_mesh
    from f5_tts_tpu_torch.utils.sampling import clamp_duration

    t_phase = time.perf_counter()
    mesh = create_mesh(devices=mesh_devices(), **MESH)
    data, ways = MESH["data"], MESH["model"]
    phase(f"mesh inference: use_mesh on a {mesh}: float and int4 requests against unsharded, cfg_interval, "
          "duration=None, K3 at the shard shapes, a W8A8 forward to the bit, a served group, the CLI")
    print(f"the grid has {len({str(d) for d in mesh.devices.flat})} distinct device(s) for {mesh.size} slots: "
          "on one card the slots share its SMs, so walls measure host cost and correctness, not scaling")
    main_path = dict(ZERO)

    def add(launched):
        for k in main_path:
            main_path[k] += launched[k]

    # -- float: the base DiT in bf16, batch 3 (padded to 4), in both sampler branches
    model = F5TTS.from_pretrained(snap, device="cuda")
    sharded = F5TTS.from_pretrained(snap, device="cuda").use_mesh(mesh)
    cfg = model.dit_cfg
    k1 = cfg.depth * EVALS_PER_REQUEST
    unsharded_expect = {**ZERO, "flash_attention_fwd": k1}
    expect = {**ZERO, "flash_attention_fwd": k1 * data * ways}
    reductions = {"sum": 2 * cfg.depth * EVALS_PER_REQUEST * data, "max": 0}
    _mesh_request(model, "float unsharded warm-up", card, unsharded_expect, None)
    _mesh_request(sharded, "float 2 x 2 warm-up", card, expect, reductions)
    want = _mesh_request(model, "float unsharded request", card, unsharded_expect, None)
    before = counts()
    got = _mesh_request(sharded, "float 2 x 2 request", card, expect, reductions)
    add({k: v - before[k] for k, v in counts().items()})
    print(f"float request wall: 2 x 2 {got[2] * 1e3:.1f} ms against unsharded {want[2] * 1e3:.1f} ms "
          f"({got[2] / want[2]:.2f}x: {data * ways}x the launches on {card})")
    _held("float 2 x 2", got[:2], want[:2], model)
    interval = dict(cfg_interval=(0.2, 0.8))
    got = _mesh_request(sharded, "float 2 x 2 cfg_interval request", card, expect, None, **interval)
    want = _mesh_request(model, "float unsharded cfg_interval request", card, unsharded_expect, None, **interval)
    _held("float 2 x 2, cfg_interval (0.2, 0.8)", got[:2], want[:2], model)
    del sharded
    _slot_kernel_checks()

    # -- int4: the quantized snapshot under 2 x 2, K3 at the shard shapes, duration=None
    q_model = F5TTS.from_pretrained(snap, device="cuda", quantization_bits=4)
    q_sharded = F5TTS.from_pretrained(snap, device="cuda", quantization_bits=4).use_mesh(mesh)
    q_unsharded_expect = {**unsharded_expect, "qmatmul": qmm_launches_per_request(cfg)}
    q_expect = {**expect, "qmatmul": mesh_qmm_launches(cfg, data, ways)}
    _mesh_request(q_sharded, "int4 2 x 2 warm-up", card, q_expect, reductions)
    want = _mesh_request(q_model, "int4 unsharded request", card, q_unsharded_expect, None)
    before = counts()
    got = _mesh_request(q_sharded, "int4 2 x 2 request", card, q_expect, reductions)
    add({k: v - before[k] for k, v in counts().items()})
    _held("int4 2 x 2", got[:2], want[:2], q_model)

    shard = q_sharded._inference_dit()[0][0].shards[-1].transformer_blocks[0]
    linears = dict(zip((s[0] for s in SHARD_SHAPES), (shard.attn.to_q, shard.attn.to_out[0], shard.ff.ff[0][0],
                                                      shard.ff.ff[2])))
    gen_x = torch.Generator(device="cuda").manual_seed(21)
    for label, k, n in SHARD_SHAPES:
        lin = linears[label]
        if tuple(lin.q.shape) != (n, k):
            raise AssertionError(f"the shard's {label} codes are {tuple(lin.q.shape)}, not ({n}, {k})")
        for dtype, tol in ((torch.bfloat16, QMM_TOL), (torch.float32, F32_TOL)):
            x = torch.randn(SHARD_M, k, generator=gen_x, device="cuda").to(dtype)
            bias = lin.bias if label in ("to_q/k/v", "ff w1") else None  # a row-parallel slot leaves its bias out
            args = (x, lin.q, lin.scales.to(dtype), lin.biases.to(dtype), bias)
            out, plain = qmatmul(*args), qmatmul_plain(*args)
            err = (out.float() - plain.float()).abs().max().item()
            ms = _time_ms(lambda: qmatmul(*args))
            print(f"K3 at the shard shape {label} [m={SHARD_M}, k={k}, n={n}] {str(dtype)[6:]}: max |kernel - "
                  f"plain| {err:.3e} (tol {tol}); {ms:.4f} ms")
            if not err <= tol:
                raise AssertionError(f"K3 at the shard shape {label} {dtype} disagrees with its plain version: {err}")

    ref, _, _ = _setup(q_model)
    mel = log_mel(q_model, ref)
    ids = q_model._tokenize(TEXT)
    predicted = q_model.predict_duration(mel, ids)
    clamped = int(clamp_duration(predicted, np.array([mel.shape[1]]), np.array([ids.shape[1]]),
                                 q_model.cfm_cfg.max_duration)[0])
    predicted = int(predicted[0])
    before, red_before = counts(), dict(all_reduce.counts)
    wave, _ = q_sharded.sample(ref[None], TEXT, steps=STEPS, method="euler", cfg_strength=2.0,
                               sway_sampling_coef=-1.0, seed=0, return_trajectory=False)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts().items()}
    reduced = {k: v - red_before[k] for k, v in all_reduce.counts.items()}
    add(launched)
    predictor_device = next(q_sharded.duration_predictor.parameters()).device
    print(f"int4 2 x 2 request with duration=None: predicted {predicted} frames, clamped {clamped}; the predictor "
          f"on {predictor_device} (the grid's first device {mesh.devices.flat[0]}); wave {tuple(wave.shape)}; "
          f"launches {launched}; reductions {reduced}")
    want_f32 = {**q_expect, "flash_attention_fwd_f32": q_model.duration_predictor.cfg.depth}
    want_shape = ((clamped - 1) * q_model.audio_cfg.hop_length,)
    if launched != want_f32 or reduced != reductions or tuple(wave.shape) != want_shape \
            or predictor_device != mesh.devices.flat[0]:
        raise AssertionError(f"the duration=None request under the mesh: launches {launched}, reductions {reduced}, "
                             f"wave {tuple(wave.shape)}; expected {want_f32}, {reductions}, clamped {clamped}")
    del q_model, q_sharded

    # -- W8A8: one DiT forward under 2 x 2 against the unsharded W8A8 forward, and the row kernels
    row_kernels = _w8a8_mesh_check(snap, mesh, card, add)

    # -- data parallelism alone (data 2): a data row samples its rows as the unsharded model samples them as a
    # batch of their own. Each half's longest duration is the group's, so the halves pad and trim as the group.
    devices = mesh_devices()
    served = F5TTS.from_pretrained(snap, device="cuda").use_mesh(
        create_mesh(data=2, devices=None if devices is None else devices[:2]))
    ref, _, _ = _setup(model)
    cond = log_mel(model, ref).expand(4, -1, -1)
    texts, frames = MESH_TEXTS + [TEXT[0][:60]], np.array(DP_FRAMES)
    kw = dict(steps=SERVE_STEPS, method="rk4", cfg_strength=2.0, sway_sampling_coef=-1.0, seed=0,
              return_trajectory=False)
    got = served.sample(cond, texts, duration=frames, **kw)
    halves = [model.sample(cond[r], texts[r], duration=frames[r], **kw) for r in (slice(0, 2), slice(2, 4))]
    whole = model.sample(cond, texts, duration=frames, **kw)
    joined = (torch.cat([h[0] for h in halves]), torch.cat([h[1] for h in halves], dim=1))
    exact = torch.equal(got[0], joined[0]) and torch.equal(got[1], joined[1])
    lens, hop = [cond.shape[1]] * 4, model.audio_cfg.hop_length
    batch = _rows_rel_l2(joined, whole, lens, DP_FRAMES, hop)
    dp = _rows_rel_l2(got, whole, lens, DP_FRAMES, hop)
    print(f"data 2 (rows {DP_FRAMES} frames, RK4 x {SERVE_STEPS}): equal to the bit to the unsharded model sampling "
          f"each data row's rows as a batch of 2: {exact}; against the unsharded batch of 4: largest relative L2 of "
          f"a row's mel {dp['mel']:.3e}, wave {dp['wave']:.3e}, as far as the unsharded model's own batches of 2 are "
          f"from its batch of 4 (mel {batch['mel']:.3e}, wave {batch['wave']:.3e}): cuBLAS picks the float layers' "
          "kernels by rows")
    if not exact:
        raise AssertionError("a data row of the mesh does not sample what the unsharded model samples for its rows")
    # a witness for the cause of that distance: the same batches of 2 and 4 with the DiT and the vocoder in float32
    model32 = F5TTS.from_pretrained(snap, device="cuda")
    model32.dit_cfg = model32.dit.cfg = model32.dit_cfg.replace(compute_dtype="float32")
    model32.vocoder.float()
    model32.vocoder.cfg = dataclasses.replace(model32.vocoder.cfg, compute_dtype="float32")
    halves32 = [model32.sample(cond[r], texts[r], duration=frames[r], **kw) for r in (slice(0, 2), slice(2, 4))]
    whole32 = model32.sample(cond, texts, duration=frames, **kw)
    joined32 = (torch.cat([h[0] for h in halves32]), torch.cat([h[1] for h in halves32], dim=1))
    batch32 = _rows_rel_l2(joined32, whole32, lens, DP_FRAMES, hop)
    # the vocoder alone on the batch of 4's mel, decoded as 2 + 2 against as 4
    mel = whole32[1][0].clone()
    mel[:, :lens[0]] = cond[:, :lens[0]]
    with torch.no_grad():
        voc4 = model32.vocoder.decode(mel, valid_frames=max(DP_FRAMES))
        voc2 = torch.cat([model32.vocoder.decode(mel[r], valid_frames=max(DP_FRAMES))
                          for r in (slice(0, 2), slice(2, 4))])
    voc = _rows_rel_l2((voc2, whole32[1]), (voc4, whole32[1]), lens, DP_FRAMES, hop)["wave"]
    print(f"float32 witness: the unsharded model with its DiT and vocoder in float32, batches of 2 against its "
          f"batch of 4: largest relative L2 of a row's mel {batch32['mel']:.3e}, wave {batch32['wave']:.3e}; the "
          f"vocoder alone on one mel, 2 + 2 against 4: wave {voc:.3e}; on {card}")
    del model32, halves32, whole32, joined32

    # -- serving over data 2 against an unsharded server: one request (each data row then samples one row, as
    # the unsharded server does) within MESH_PCM_LSB; a group of four, split 2 + 2, equal to the bit to the
    # unsharded model answering each data row's pair as a group of its own, as data 2 above; its distance from
    # the unsharded group of four (a batch of 2 against a batch of 4, above) is printed
    plain = _served_pcm(model, "unsharded server", card)
    over = _served_pcm(served, "server over data 2", card)
    single = _pcm_apart({7.0: over["single"]}, {7.0: plain["single"]})
    group = _pcm_apart(over["group"], plain["group"])
    order = [(q.text, q.duration_frames) for q in over["groups"][0]] if over["sizes"] == [4] else None
    pairs = _pairs_pcm(model, over["groups"][0]) if order else {}
    pairs_apart = _pcm_apart(over["group"], pairs) if pairs.keys() == over["group"].keys() else None
    print(f"served over data 2 against unsharded: one request {single[0]} LSB apart (tol {MESH_PCM_LSB}); the group "
          f"of four (split 2 + 2 over the data rows; groups {over['sizes']} and {plain['sizes']}; the batcher's "
          f"order {order}) against the unsharded model answering each data row's pair as a group: "
          f"{pairs_apart} (LSB, relative L2; tol 0: to the bit); against the unsharded group of four {group[0]} LSB, "
          f"relative L2 of a request {group[1]:.3e}")
    if over["sizes"] != [4] or plain["sizes"] != [4] or single[0] > MESH_PCM_LSB or pairs_apart != (0, 0.0) \
            or any(over["group"][t].shape != plain["group"][t].shape for t in over["group"]):
        raise AssertionError(f"the server over data 2: groups {over['sizes']} and {plain['sizes']}, one request "
                             f"{single}, the group against its pairs {pairs_apart}")
    del served

    # -- the CLI's --mesh-data 2 over its default devices (every card)
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--model", snap, "--text", "A request over the mesh.", "--duration", "4", "--seed", "0",
                "--mesh-data", "2", "--output", f"{tmp}/mesh.wav"]
        if torch.cuda.device_count() >= 2:
            gen.main(argv)
            print(f"CLI --mesh-data 2 over {torch.cuda.device_count()} cards: wrote {tmp}/mesh.wav")
        else:
            try:
                gen.main(argv)
            except ValueError as e:
                message = str(e)
            else:
                raise AssertionError("the CLI's --mesh-data 2 on one card did not refuse")
            print(f"CLI --mesh-data 2 on one card: ValueError {message!r}")
            if message != "mesh 2x1x1 needs 2 devices, have 1":
                raise AssertionError(f"the CLI's --mesh-data 2 on one card raised {message!r}")
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s; launches of its sharded requests and forwards "
          f"{main_path}; on {card}")
    return main_path, row_kernels


def _w8a8_mesh_check(snap: str, mesh, card: str, add) -> dict:
    """One W8A8 DiT forward under 2 x 2 (4 rows of 1024 frames with their
    own key masks; each data row's group on its 2 rows) against the
    unsharded W8A8 forward: each data row to the bit against the unsharded
    forward of its rows, and the gathered batch against the unsharded
    forward of all 4. The row-parallel kernels bit for bit against their
    plain versions at the slot shapes, timed. Returns their rows for the
    kernels line."""
    import torch

    from f5_tts_tpu_torch import F5TTS
    from f5_tts_tpu_torch.ops import w8a8 as W
    from f5_tts_tpu_torch.parallel.mesh import all_reduce

    model = F5TTS.from_pretrained(snap, device="cuda")
    model.dit_cfg = model.dit_cfg.replace(int8_compute=True)
    dit = model._inference_dit()  # the unsharded W8A8 copy, kept here: use_mesh drops the model's reference
    groups = model.use_mesh(mesh)._inference_dit()
    cfg = model.dit_cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    b, n = 4, 1024
    x, cond = (torch.randn(b, n, 100, generator=g, device="cuda") for _ in range(2))
    text = torch.randint(0, 95, (b, 120), generator=g, device="cuda")
    mask = torch.arange(n, device="cuda")[None] < torch.tensor([[n], [900], [n], [700]], device="cuda")[:, :1]
    with torch.no_grad():
        te = dit.embed_text(text, n)
        mods = {k: v[0] for k, v in dit.time_mods(torch.tensor([0.4], device="cuda")).items()}
        want = dit(x, cond, te, mods, mask=mask)
        rows = [slice(0, 2), slice(2, 4)]
        want_rows = [dit(x[r], cond[r], te[r], mods, mask=mask[r]) for r in rows]
        before, red_before = counts(), dict(all_reduce.counts)
        row_before = (W.row_absmax.launches, W.quantize_scaled.launches)
        got = [grp(x[r], cond[r], te[r], mods, mask=mask[r]) for (grp, _), r in zip(groups, rows)]
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts().items()}
    add(launched)
    reduced = {k: v - red_before[k] for k, v in all_reduce.counts.items()}
    row_launched = (W.row_absmax.launches - row_before[0], W.quantize_scaled.launches - row_before[1])
    per_row = [torch.equal(a, w) for a, w in zip(got, want_rows)]
    whole = torch.cat(got)
    whole_exact = torch.equal(whole, want)
    rel = ((whole - want).norm() / want.norm()).item()
    batch_rel = ((torch.cat(want_rows) - want).norm() / want.norm()).item()
    slots = MESH["data"] * MESH["model"]
    expect = {**ZERO, "flash_attention_fwd": slots * cfg.depth, "w8a8_quantize": slots * 4 * cfg.depth,
              "w8a8_rescale": slots * 6 * cfg.depth, "w8a8_row_absmax": slots * 2 * cfg.depth,
              "w8a8_quantize_scaled": slots * 2 * cfg.depth}
    red_expect = {"sum": MESH["data"] * 2 * cfg.depth, "max": MESH["data"] * 2 * cfg.depth}
    print(f"W8A8 DiT forward under 2 x 2 ({b} x {n} frames): each data row against the unsharded forward of its rows "
          f"equal to the bit: {per_row}; the gathered batch against the unsharded forward of all {b}: equal to the "
          f"bit {whole_exact}, relative L2 {rel:.3e} (the unsharded forward of 2 rows against the same rows in its "
          f"forward of {b}: {batch_rel:.3e}); launches {launched}; reductions {reduced}; row kernels "
          f"{row_launched}; on {card}")
    # the tensor-parallel split is exact (the int32 sums and the max over the slots); the data split changes the
    # batch of the float layers outside the W8A8 linears (input projection, proj_out: cuBLAS picks its kernel by
    # m), so the whole batch is held to W8A8_DIT_TOL where it is not equal to the bit
    if not all(per_row) or not (whole_exact or rel <= W8A8_DIT_TOL["bfloat16"]):
        raise AssertionError(f"the W8A8 forward under 2 x 2 disagrees with the unsharded one: rows {per_row}, "
                             f"whole {rel}")
    if launched != expect or reduced != red_expect:
        raise AssertionError(f"W8A8 forward under 2 x 2: launches {launched}, reductions {reduced}; expected "
                             f"{expect}, {red_expect}")
    del model, groups, dit

    phase("W8A8 row-parallel kernels vs plain, bit for bit: row_absmax and quantize_scaled (Triton)")
    results = {}
    for label, k in (("to_out", 512), ("ff w2", 1024)):
        whole_x = torch.randn(SHARD_M, 2 * k, generator=g, device="cuda").to(torch.bfloat16)
        halves = [h.contiguous() for h in whole_x.chunk(2, dim=-1)]
        x = halves[0]
        amaxes = [W.row_absmax(h) for h in halves]
        amax = torch.maximum(*amaxes)
        codes, sx = W.quantize_scaled(x, amax)
        ref_amax, (ref_codes, ref_sx) = W.row_absmax_plain(x), W.quantize_scaled_plain(x, amax)
        whole_codes, whole_sx = W.quantize_rows(whole_x)
        errs = {"row_absmax": (amaxes[0] - ref_amax).abs().max().item(),
                "quantize_scaled": (codes.int() - ref_codes.int()).abs().max().item()
                + (sx - ref_sx).abs().max().item()}
        exact = (torch.equal(amaxes[0], ref_amax) and torch.equal(codes, ref_codes) and torch.equal(sx, ref_sx)
                 and torch.equal(codes, whole_codes[:, :k]) and torch.equal(sx, whole_sx))
        name = f"{label} slot input [m={SHARD_M}, k={k}] bfloat16"
        print(f"{name}: max |kernel - plain| {errs}; equal to the whole row's quantize_rows: "
              f"{'yes' if exact else 'NO'}")
        if not exact:
            raise AssertionError(f"a W8A8 row kernel disagrees with its plain version at {name}: {errs}")
        runs = {
            "row_absmax": (lambda: W.row_absmax(x), lambda: W.row_absmax_plain(x),
                           lambda: torch.linalg.vector_norm(x, float("inf"), dim=-1, dtype=torch.float32),
                           bound(2 * x.numel(), nbytes(x, ref_amax), "f32")),
            "quantize_scaled": (lambda: W.quantize_scaled(x, amax), lambda: W.quantize_scaled_plain(x, amax), None,
                                bound(4 * x.numel(), nbytes(x, amax, ref_codes, ref_sx), "f32")),
        }
        for part, (fn, plain, library, (bound_ms, bound_by)) in runs.items():
            ms, plain_ms, dev = _time_ms(fn), _time_ms(plain), device_ms(fn)
            lib_ms = None if library is None else _time_ms(library)
            print(f"{name} {part}: kernel {ms:.4f} ms, device {dev:.4f} ms, plain {plain_ms:.4f} ms")
            _library_line(f"{name} {part}", "torch.linalg.vector_norm(ord=inf, dtype=float32)", lib_ms, bound_ms,
                          bound_by)
            results[(part, label)] = {"err": errs[part], "ms": ms, "plain_ms": plain_ms, "device_ms": dev,
                                      "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    return results


# (label, m, k, n) of the W8A8 linears: the DiT blocks' three shapes over 2 x 1024 frames (CFG), then a ragged m
# and m <= 16 (padded to 32 rows for torch._int_mm)
W8A8_SHAPES = [("to_q/k/v/out", 2048, 1024, 1024), ("ff w1", 2048, 1024, 2048), ("ff w2", 2048, 2048, 1024),
               ("ragged m", 1000, 1024, 1024), ("m <= 16", 5, 1024, 1024)]
W8A8_LINEARS = 6  # a block's attention q, k, v, out and feed-forward w1, w2


def w8a8_kernel_phase() -> dict:
    """quantize_rows, torch._int_mm, rescale_bias and the whole W8A8 linear
    bit for bit against the plain versions, with their times, device times
    and bounds, and the linear beside bf16 F.linear; then int8_probe."""
    import torch
    import torch.nn.functional as F

    from f5_tts_tpu_torch.ops import w8a8 as W
    from f5_tts_tpu_torch.tools import int8_probe

    phase("W8A8 kernels vs plain, bit for bit: quantize_rows and rescale_bias (Triton), torch._int_mm")
    gen = torch.Generator(device="cuda").manual_seed(11)
    results = {}
    for label, m, k, n in W8A8_SHAPES:
        for dtype in (torch.bfloat16, torch.float32) if label == "to_q/k/v/out" else (torch.bfloat16,):
            name = f"{label} [m={m}, k={k}, n={n}] {str(dtype).removeprefix('torch.')}"
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            w8, scale = W.quantize_rows_plain(torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5)
            bias = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
            rows = m if m >= W.MIN_INT_MM_ROWS else W.PAD_ROWS
            codes, sx = W.quantize_rows(x, rows)
            ref_codes, ref_sx = W.quantize_rows_plain(x)
            acc = torch._int_mm(codes, w8.t())
            ref_acc = W.int8_product_plain(ref_codes, w8)
            y = W.rescale_bias(ref_acc, ref_sx, scale, bias, dtype)
            ref_y = W.rescale_bias_plain(ref_acc, ref_sx, scale, bias, dtype)
            out = W.w8a8_linear(x, w8, scale, bias)
            ref_out = W.w8a8_linear_plain(x, w8, scale, bias)
            torch.cuda.synchronize()
            errs = {"quantize": (codes[:m].int() - ref_codes.int()).abs().max().item()
                    + (sx[:m] - ref_sx).abs().max().item() + codes[m:].abs().sum().item(),
                    "int_mm": (acc[:m] - ref_acc).abs().max().item(),
                    "rescale": (y.float() - ref_y.float()).abs().max().item(),
                    "linear": (out.float() - ref_out.float()).abs().max().item()}
            exact = (torch.equal(codes[:m], ref_codes) and torch.equal(sx[:m], ref_sx) and not codes[m:].any()
                     and torch.equal(acc[:m], ref_acc) and torch.equal(y, ref_y) and torch.equal(out, ref_out))
            print(f"{name}: max |kernel - plain| {errs} (bit for bit: {'yes' if exact else 'NO'})")
            if not exact:
                raise AssertionError(f"a W8A8 kernel disagrees with its plain version at {name}: {errs}")
            acc_m = ref_acc.contiguous()
            runs = {
                "quantize": (lambda: W.quantize_rows(x, rows), lambda: W.quantize_rows_plain(x),
                             bound(4 * m * k, nbytes(x, ref_codes, ref_sx), "f32")),
                "rescale": (lambda: W.rescale_bias(acc_m, ref_sx, scale, bias, dtype),
                            lambda: W.rescale_bias_plain(acc_m, ref_sx, scale, bias, dtype),
                            bound(3 * m * n, nbytes(acc_m, ref_sx, scale, bias, y), "f32")),
            }
            for part, (fn, plain, (bound_ms, bound_by)) in runs.items():
                ms, plain_ms, dev = _time_ms(fn), _time_ms(plain), device_ms(fn)
                print(f"{name} {part}: kernel {ms:.4f} ms, device {dev:.4f} ms, plain {plain_ms:.4f} ms")
                _library_line(f"{name} {part}", "", None, bound_ms, bound_by)
                results[(part, label, dtype)] = {"err": errs[part], "ms": ms, "plain_ms": plain_ms,
                                                 "device_ms": dev, "library_ms": None, "bound_ms": bound_ms,
                                                 "bound_by": bound_by}
            int_mm_dev = device_ms(lambda: torch._int_mm(codes, w8.t()))
            int_mm_bound = bound(2 * rows * k * n, nbytes(codes, w8, acc), "int8")
            w_float = (w8.float() * scale[:, None]).to(dtype)
            lin_ms, lin_dev = _time_ms(lambda: W.w8a8_linear(x, w8, scale, bias)), \
                device_ms(lambda: W.w8a8_linear(x, w8, scale, bias))
            f_ms, f_dev = _time_ms(lambda: F.linear(x, w_float, bias)), device_ms(lambda: F.linear(x, w_float, bias))
            lin_bound = bound(2 * m * k * n, nbytes(x, w8, scale, bias, out), "int8")
            print(f"{name}: torch._int_mm device {int_mm_dev:.4f} ms (bound {int_mm_bound[0] * 1e3:.2f} us, "
                  f"{int_mm_bound[1]}); W8A8 linear {lin_ms:.4f} ms, device {lin_dev:.4f} ms (bound "
                  f"{lin_bound[0] * 1e3:.2f} us, {lin_bound[1]}) against F.linear {f_ms:.4f} ms, device {f_dev:.4f} ms: "
                  f"device {lin_dev / f_dev:.2f}x")
    int8_probe.main(reps=10)
    return results


def _flagged_snapshot(snap: str, dst: Path) -> Path:
    """`snap`'s files linked into `dst`, with a config.json that sets
    int8_compute."""
    for p in Path(snap).rglob("*"):
        if p.is_file() and p.name != "config.json":
            (dst / p.relative_to(snap)).parent.mkdir(parents=True, exist_ok=True)
            os.symlink(p, dst / p.relative_to(snap))
    blob = json.loads((Path(snap) / "config.json").read_text())
    blob["dit"]["int8_compute"] = True
    (dst / "config.json").write_text(json.dumps(blob))
    return dst


def _w8a8_block_errors(card, cpu_dits: dict) -> dict:
    """Each block of the DiT `card` (on the card) against the same block of
    each CPU DiT of `cpu_dits` (the same compute dtype), fed the card's
    input to that block: per block, the L2 distance of the outputs over the
    L2 size of the block's update (output less input). Fed the same input,
    a block is held without the earlier blocks' differences growing
    through it."""
    import torch

    from f5_tts_tpu_torch.models.rope import rotary_freqs

    x, cond, text, mask, drop, t = _dit_inputs()
    rel = {label: [] for label in cpu_dits}
    dt = card.compute_dtype
    with torch.no_grad():
        dev = {k: v.cuda() for k, v in (("x", x), ("cond", cond), ("text", text), ("mask", mask), ("drop", drop))}
        te = card.embed_text(dev["text"], x.shape[1])
        mods = {k: v[0] for k, v in card.time_mods(t.cuda()).items()}
        h = card.input_embed(dev["x"].to(dt), dev["cond"].to(dt), te, drop_audio_cond=dev["drop"])
        raw = rotary_freqs(x.shape[1], card.cfg.dim_head, device="cuda")
        rope = (torch.cos(raw), torch.sin(raw))
        for i, (block, mod) in enumerate(zip(card.transformer_blocks, mods["blocks"])):
            out = block(h, mod, mask=dev["mask"], rope=rope)
            h_cpu, out_cpu = h.cpu(), out.cpu()
            for label, dit in cpu_dits.items():
                want = dit.transformer_blocks[i](h_cpu, mod.cpu(), mask=mask, rope=tuple(r.cpu() for r in rope))
                rel[label].append(((out_cpu.float() - want.float()).norm()
                                   / (want.float() - h_cpu.float()).norm()).item())
            h = out
    return rel


def _w8a8_dit_check(model_w8) -> dict:
    """The W8A8 DiT on the card against the plain W8A8 DiT on the CPU, on
    `_dit_out`'s input, in bf16 (the float32 master cast, then its blocks
    re-quantized, as the sampler does) and in float32. Block by block, each
    block fed the card's input to it: the CPU's W8A8 block must come within
    W8A8_BLOCK_TOL of the card's, and the CPU's float block (no W8A8) must
    miss it, so the check tells W8A8 from float in both dtypes. The whole
    forward is held to W8A8_DIT_TOL, which the float DiT meets too: a code
    next to a rounding boundary moves by one where the two sides'
    activations differ by an ulp, and later layers carry that on, so over
    22 layers the distance is of the size of W8A8's own error."""
    import torch

    from f5_tts_tpu_torch import F5TTS
    from f5_tts_tpu_torch.models.dit import DiT

    phase("DiT forward (W8A8): the card against the plain W8A8 forward on the CPU, block by block and whole")
    state = model_w8.dit.state_dict()

    def sampler_dit(dev: str, dtype: str, int8: bool):
        cfg = model_w8.dit_cfg.replace(compute_dtype=dtype, int8_compute=int8)
        with torch.device(dev):
            dit = DiT(cfg)
        dit.load_state_dict(state)
        return F5TTS(dit, cfg)._inference_dit()

    card = {"bfloat16": model_w8._inference_dit(), "float32": sampler_dit("cuda", "float32", True)}
    rel, blocks, ok = {}, {}, True
    for dtype, card_dit in card.items():
        out = _dit_out(card_dit, "cuda")
        cpu = {label: sampler_dit("cpu", dtype, int8) for label, int8 in (("W8A8", True), ("float", False))}
        for label, dit in cpu.items():
            ref = _dit_out(dit, "cpu")
            rel[(dtype, label)] = ((out - ref).norm() / ref.norm()).item()
        blocks[dtype] = _w8a8_block_errors(card_dit, cpu)
        w8, fl = blocks[dtype]["W8A8"], blocks[dtype]["float"]
        print(f"{dtype}, block by block, each fed the card's input: |card - CPU| / |CPU update|, W8A8 "
              f"{min(w8):.3e} to {max(w8):.3e} (tol {W8A8_BLOCK_TOL[dtype]}), float {min(fl):.3e} to "
              f"{max(fl):.3e} (must miss); by block W8A8 " + ", ".join(f"{e:.2e}" for e in w8))
        print(f"{dtype}, whole forward: relative L2 of the W8A8 card forward against the CPU's W8A8 "
              f"{rel[(dtype, 'W8A8')]:.3e} (tol {W8A8_DIT_TOL[dtype]}; the CPU's without W8A8 "
              f"{rel[(dtype, 'float')]:.3e})")
        ok &= max(w8) <= W8A8_BLOCK_TOL[dtype] < min(fl) and rel[(dtype, "W8A8")] <= W8A8_DIT_TOL[dtype]
    if not ok:
        raise AssertionError(f"the W8A8 DiT forward on the card: {rel}, blocks {blocks}, tolerances "
                             f"{W8A8_DIT_TOL}, {W8A8_BLOCK_TOL}")
    return rel


def w8a8_path_phase(card: str, snap: str, tmp_base: str | None) -> tuple[list, dict]:
    """W8A8 synthesis through the entry points: generate(int8_compute=True)
    on the caller's float model, then a snapshot whose config sets
    int8_compute, in turns with the float model; the mel against the float
    mel, a profile, the DiT forward against the CPU and one served request.
    Returns the three W8A8 requests' walls and their launches."""
    import numpy as np
    import torch

    from f5_tts_tpu_torch import F5TTS
    from f5_tts_tpu_torch import generate as gen
    from f5_tts_tpu_torch.audio.io import write_wav
    from f5_tts_tpu_torch.models.quant import W8A8Linear
    from f5_tts_tpu_torch.serve import serve

    phase("W8A8 path: generate(int8_compute=True), then from_pretrained of a snapshot with int8_compute -> "
          "1 + 3 requests in turns with the float model, mel vs float, profile, DiT forward, one served request")
    model = F5TTS.from_pretrained(snap, device="cuda")
    ref, duration, expect_len = _setup(model)
    cfg, sr = model.dit_cfg, model.audio_cfg.sample_rate
    linears = W8A8_LINEARS * cfg.depth * EVALS_PER_REQUEST
    per_request = {**ZERO, "flash_attention_fwd": cfg.depth * EVALS_PER_REQUEST, "w8a8_quantize": linears,
                   "w8a8_rescale": linears}
    float_request = {**ZERO, "flash_attention_fwd": cfg.depth * EVALS_PER_REQUEST}
    print(f"expected per W8A8 request: {per_request}")
    reset_counts()
    with tempfile.TemporaryDirectory(dir=tmp_base) as tmp:
        write_wav(f"{tmp}/ref.wav", ref.cpu().numpy(), sr)
        before = counts()
        t0 = time.perf_counter()
        wave = gen.generate(TEXT[0], duration=10.0, model=model, ref_audio_path=f"{tmp}/ref.wav",
                            ref_audio_text="A tone.", steps=STEPS, method="euler", cfg_strength=2.0,
                            sway_sampling_coef=-1.0, seed=0, int8_compute=True, play=False)
        wall = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in counts().items()}
        print(f"generate(int8_compute=True, model=float model): {wall * 1e3:.1f} ms with the W8A8 copy's build, "
              f"{wave.shape[0]} samples; launches {launched}; caller's model int8_compute "
              f"{model.dit_cfg.int8_compute}")
        if launched != per_request or model.dit_cfg.int8_compute or wave.shape != (expect_len - ref.shape[0],) \
                or not np.isfinite(wave).all():
            raise AssertionError(f"generate(int8_compute=True): launches {launched}, wave {wave.shape}, caller's "
                                 f"flag {model.dit_cfg.int8_compute}")

        model_w8 = F5TTS.from_pretrained(_flagged_snapshot(snap, Path(tmp) / "w8a8"), device="cuda")
    if not model_w8.dit_cfg.int8_compute:
        raise AssertionError("the snapshot's int8_compute did not reach the loaded model")
    _request(model, ref, duration, card, "float warm-up", float_request, expect_len)
    _request(model_w8, ref, duration, card, "W8A8 warm-up", per_request, expect_len)
    if not all(isinstance(blk.attn.to_q, W8A8Linear) for blk in model_w8._inference_dit().transformer_blocks):
        raise AssertionError("the W8A8 model's sampler copy has float attention projections")
    walls, peaks = {"W8A8": [], "float": []}, {"W8A8": [], "float": []}
    main_path = dict(ZERO)  # the launches of the three W8A8 requests, the phase's main path, alone
    for i in range(3):
        for label, m, expect in (("W8A8", model_w8, per_request), ("float", model, float_request)):
            before = counts()
            walls[label].append(_request(m, ref, duration, card, f"{label} request {i + 1}", expect, expect_len))
            peaks[label].append(torch.cuda.max_memory_allocated())
            if label == "W8A8":
                main_path = {k: v + counts()[k] - before[k] for k, v in main_path.items()}
    print(f"W8A8 requests {', '.join(f'{t * 1e3:.1f}' for t in walls['W8A8'])} ms against float "
          f"{', '.join(f'{t * 1e3:.1f}' for t in walls['float'])} ms in turns; peak memory W8A8 "
          f"{max(peaks['W8A8']) / 2**30:.3f} GiB, float {max(peaks['float']) / 2**30:.3f} GiB; on {card}")
    if max(peaks["W8A8"]) > max(peaks["float"]) + 2**26:
        raise AssertionError("a W8A8 request's peak memory exceeds the float request's by more than 64 MiB")

    mels = {}
    for label, m in (("W8A8", model_w8), ("float", model)):
        _, traj = m.sample(ref[None], TEXT, duration=duration, steps=STEPS, method="euler", cfg_strength=2.0,
                           sway_sampling_coef=-1.0, seed=0, return_trajectory=False)
        ref_frames = ref.shape[0] // model.audio_cfg.hop_length
        mels[label] = traj[-1][0, ref_frames:duration].float()
    mel_rel = ((mels["W8A8"] - mels["float"]).norm() / mels["float"].norm()).item()
    print(f"W8A8 mel against the float mel of the same noise: relative L2 {mel_rel:.4e} over the generated frames")
    if not 0 < mel_rel < 5e-2:
        raise AssertionError(f"the W8A8 mel is {mel_rel} from the float mel")

    def request():
        model_w8.sample(ref[None], TEXT, duration=duration, steps=STEPS, method="euler", cfg_strength=2.0,
                        sway_sampling_coef=-1.0, seed=0, return_trajectory=False)

    _profiled("W8A8 request", request)
    del model
    _w8a8_dit_check(model_w8)

    ref_audio, _ = gen._load_ref_audio(None, None)
    ref_frames = ref_audio.shape[0] // model_w8.audio_cfg.hop_length
    httpd = serve(model_w8, "127.0.0.1", 0, max_batch=1, max_wait_ms=10)
    try:
        before = counts()
        t0 = time.perf_counter()
        body = _ok(httpd.server_address[1], {"text": "A request served with int8 compute.", "duration": 7.0,
                                            "steps": SERVE_STEPS, "method": "rk4", "seed": 0}, "W8A8 served request")
        served = {k: v - before[k] for k, v in counts().items()}
    finally:
        httpd.batcher.stop()
        httpd.shutdown()
        httpd.batcher.join(timeout=60)
    a = model_w8.audio_cfg
    want = 44 + 2 * ((int(7.0 * a.frames_per_second) - 1 - ref_frames) * a.hop_length)
    evals = (SERVE_STEPS - 1) * 4
    expect = {**ZERO, "flash_attention_fwd": evals * cfg.depth, "w8a8_quantize": evals * W8A8_LINEARS * cfg.depth,
              "w8a8_rescale": evals * W8A8_LINEARS * cfg.depth}
    print(f"W8A8 served request (7 s, RK4 at {SERVE_STEPS} steps): {time.perf_counter() - t0:.3f} s, "
          f"{len(body)} bytes (expected {want}); launches {served}")
    if len(body) != want or served != expect:
        raise AssertionError(f"the W8A8 served request: {len(body)} bytes, launches {served}; expected {want}, "
                             f"{expect}")
    return walls["W8A8"], main_path


SERVE_STEPS = 8  # RK4 over an 8-point grid: 7 intervals x 4 flow evaluations
SERVE_DURATIONS = (6.0, 6.5, 7.0, 7.5)  # 562 to 703 frames: one 256-frame bucket
SERVE_FRAMES = (562, 609, 656, 703)
# relative L2 of each row's generated mel frames and wave samples, K1 against plain attention over 28
# evaluations of the random base DiT (measured 2.3e-3 and 6.9e-3 on the H100; a row given the next row's
# key mask moves the mel by 0.74 to 2.6%)
SERVE_TOL = {"mel": 5e-3, "wave": 1.5e-2}
CLI_TEXT = "The first sentence is short. The second sentence of this request is longer than the first one."
STREAM_TEXT = "A stream starts here. It goes on a little. And then it ends."


def _expected_samples(model, ref_audio, ref_text, texts, ref_frames) -> list:
    """Samples of each generated piece whose duration comes from the
    text-length heuristic: the clamped frames, less the last, less the
    reference's."""
    import numpy as np

    from f5_tts_tpu_torch.generate import estimated_duration
    from f5_tts_tpu_torch.models.cfm import clamp_duration
    from f5_tts_tpu_torch.utils.tokenizer import convert_char_to_pinyin

    a = model.audio_cfg
    out = []
    for s in texts:
        est = int(estimated_duration(ref_audio, ref_text, s, hop_length=a.hop_length,
                                     frames_per_second=a.frames_per_second) * a.frames_per_second)
        n_text = int((model._tokenize(convert_char_to_pinyin([ref_text + " " + s])) != -1).sum())
        dur = int(clamp_duration(np.array([est]), np.array([ref_frames]), np.array([n_text]),
                                 model.cfm_cfg.max_duration)[0])
        out.append((dur - 1 - ref_frames) * a.hop_length)
    return out


def _check_wav(path: str, expect_len: int, label: str) -> None:
    import numpy as np

    from f5_tts_tpu_torch.audio.io import read_wav

    audio, sr = read_wav(path)
    print(f"{label}: {audio.shape[0]} samples at {sr} Hz (expected {expect_len}), peak {np.abs(audio).max():.4f}")
    if audio.shape != (expect_len,) or not np.isfinite(audio).all() or not (audio != 0).any():
        raise AssertionError(f"{label}: the WAV is {audio.shape} samples, not ({expect_len},), or not finite, "
                             "or silent")


def _post(port: int, payload: dict, path: str = "/synthesize"):
    """POST JSON; returns (status, body), reading the error body too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _ok(port: int, payload: dict, label: str) -> bytes:
    status, body = _post(port, payload)
    if status != 200 or body[:4] != b"RIFF":
        raise AssertionError(f"{label}: HTTP {status} {body[:300]!r}")
    return body


def _stream(port: int, payload: dict) -> tuple[list, float, float]:
    """A /synthesize_stream request over a raw socket: (chunks, seconds to
    the first PCM chunk, seconds to the terminal chunk)."""
    import socket

    body = json.dumps(payload).encode()
    req = (f"POST /synthesize_stream HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
           f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode() + body
    raw, chunks, t_first, t_end = b"", [], None, None
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port), timeout=600) as s:
        s.sendall(req)
        while True:
            data = s.recv(1 << 16)
            if not data:
                break
            raw += data
            head, sep, rest = raw.partition(b"\r\n\r\n")
            if not sep:
                continue
            if not head.startswith(b"HTTP/1.1 200"):
                continue
            chunks, done = [], False
            while rest:
                size_hex, crlf, tail = rest.partition(b"\r\n")
                if not crlf or len(tail) < int(size_hex, 16) + 2:
                    break
                size = int(size_hex, 16)
                if size == 0:
                    done = True
                    break
                chunks.append(tail[:size])
                rest = tail[size + 2:]
            if len(chunks) > 1 and t_first is None:
                t_first = time.perf_counter() - t0
            if done and t_end is None:
                t_end = time.perf_counter() - t0
    status = raw.split(b"\r\n", 1)[0]
    if b" 200 " not in status + b" " or t_end is None:
        raise AssertionError(f"stream: {status!r}, ended {'normally' if t_end else 'without its terminal chunk'}")
    return chunks, t_first, t_end


def serving_phase(card: str, snap: str) -> tuple[dict, dict]:
    """The user-facing entry points on the float snapshot: the generate CLI
    twice (the batched branch, and one sentence with a guidance interval),
    then `serve` with warm-ups, four concurrent requests of one bucket, a
    request whose duration the predictor sets, a stream, a malformed
    request, and the serve_latency measurement. Returns the kernels'
    launches over the phase and the latencies."""
    import threading

    import torch

    from f5_tts_tpu_torch import generate as gen
    from f5_tts_tpu_torch.models.cfm import F5TTS
    from f5_tts_tpu_torch.serve import serve, warmup
    from f5_tts_tpu_torch.tools import serve_latency

    phase("serving: the generate CLI (batched; one sentence with cfg_interval), then serve() -> warm-up, "
          "4 concurrent requests, duration=None, a stream, a 400, serve_latency")
    reset_counts()
    t_phase = time.perf_counter()
    ref_audio, ref_text = gen._load_ref_audio(None, None)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        gen.main(["--model", snap, "--text", CLI_TEXT, "--seed", "0", "--estimate-duration",
                  "--output", f"{tmp}/two.wav"])
        t1 = time.perf_counter()
        gen.main(["--model", snap, "--text", "One sentence with guidance in an interval.", "--duration", "7",
                  "--cfg-interval", "0.2,0.8", "--seed", "0", "--output", f"{tmp}/one.wav"])
        t2 = time.perf_counter()
        model = F5TTS.from_pretrained(snap, device="cuda")
        a = model.audio_cfg
        ref_frames = ref_audio.shape[0] // a.hop_length
        _check_wav(f"{tmp}/two.wav", sum(_expected_samples(model, ref_audio, ref_text,
                                                           gen.split_sentences(CLI_TEXT), ref_frames)),
                   f"CLI, batched branch ({t1 - t0:.1f} s with the load)")
        _check_wav(f"{tmp}/one.wav", (int(7 * a.frames_per_second) - 1) * a.hop_length - ref_audio.shape[0],
                   f"CLI, --duration 7 --cfg-interval 0.2,0.8 ({t2 - t1:.1f} s with the load)")

    httpd = serve(model, "127.0.0.1", 0, max_batch=4, max_wait_ms=80)
    port = httpd.server_address[1]
    try:
        t0 = time.perf_counter()
        warmup(model, [7.0], steps=SERVE_STEPS, method="rk4", batch_sizes=(1, 4), batcher=httpd.batcher)
        print(f"warm-up (7 s at batch 1 and 4, and the predictor): {time.perf_counter() - t0:.1f} s")
        groups = []  # (size, K1 launches, K1-f32 launches) of each group, in the batcher thread
        run_group = httpd.batcher._run_group

        def recording(group):
            before = counts()
            run_group(group)
            after = counts()
            groups.append((len(group), after["flash_attention_fwd"] - before["flash_attention_fwd"],
                           after["flash_attention_fwd_f32"] - before["flash_attention_fwd_f32"]))

        httpd.batcher._run_group = recording
        calls = []  # (args, kwargs, output) of each sample() call of the four concurrent requests
        sample = model.sample

        def recording_sample(*args, **kw):
            out = sample(*args, **kw)
            calls.append((args, kw, out))
            return out

        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            if r.status != 200 or json.loads(r.read()) != {"status": "ok"}:
                raise AssertionError("healthz did not answer ok")

        bodies, errors = {}, []

        def hit(sec):
            try:
                bodies[sec] = _ok(port, {"text": f"A request of {sec} seconds in all.", "duration": sec,
                                         "steps": SERVE_STEPS, "method": "rk4", "seed": 0}, f"{sec} s request")
            except Exception as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=hit, args=(sec,)) for sec in SERVE_DURATIONS]
        model.sample = recording_sample
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        concurrent_s = time.perf_counter() - t0
        del model.sample
        if errors or len(bodies) != len(SERVE_DURATIONS):
            raise AssertionError(f"concurrent requests failed: {errors}")
        sizes = [g[0] for g in groups]
        print(f"4 concurrent requests ({', '.join(map(str, SERVE_DURATIONS))} s): {concurrent_s:.3f} s; "
              f"group sizes {sizes}")
        if sum(sizes) != 4 or max(sizes) < 2:
            raise AssertionError(f"the four requests of one bucket ran in groups {sizes}")
        for sec, body in bodies.items():
            want = 44 + 2 * ((int(sec * a.frames_per_second) - 1 - ref_frames) * a.hop_length)
            if len(body) != want:
                raise AssertionError(f"the {sec} s answer is {len(body)} bytes, expected {want}")

        f32_before = counts()["flash_attention_fwd_f32"]
        body = _ok(port, {"text": "The predictor sets this request's duration.", "steps": SERVE_STEPS,
                          "method": "rk4", "seed": 0}, "duration=None request")
        f32 = counts()["flash_attention_fwd_f32"] - f32_before
        print(f"duration=None request: {len(body)} bytes; K1-f32 launches {f32}")
        if f32 <= 0:
            raise AssertionError("the duration=None request did not launch K1-f32")

        chunks, t_first, t_end = _stream(port, {"text": STREAM_TEXT, "estimate_duration": True,
                                                "steps": SERVE_STEPS, "method": "rk4", "seed": 0})
        pcm = sum(map(len, chunks[1:]))
        want = 2 * sum(_expected_samples(model, ref_audio, ref_text, gen.split_sentences(STREAM_TEXT), ref_frames))
        print(f"stream of 3 sentences: first PCM at {t_first:.3f} s, end at {t_end:.3f} s, {len(chunks) - 1} "
              f"PCM chunks, {pcm} bytes (expected {want})")
        if chunks[0][:4] != b"RIFF" or t_first is None or not t_first < t_end or pcm != want:
            raise AssertionError("the stream's header, first PCM chunk or length is wrong")

        status, body = _post(port, {"text": "hi", "steps": "many"})
        print(f"malformed request: HTTP {status} {body[:80]!r}")
        if status != 400:
            raise AssertionError(f"a malformed request got HTTP {status}, not 400")

        t0 = time.perf_counter()
        lat = serve_latency.measure(port)
        print(f"serve_latency ({time.perf_counter() - t0:.1f} s): " + json.dumps(lat))
        torch.cuda.synchronize()
    finally:
        httpd.batcher.stop()
        httpd.shutdown()
        httpd.batcher.join(timeout=60)
    launched = counts()
    per_group = (SERVE_STEPS - 1) * 4 * model.dit_cfg.depth
    k1 = sorted({g[1] for g in groups})
    print(f"serving: warm_synthesize_s {lat['warm_synthesize_s']:.4f}, stream_ttfa_s {lat['stream_ttfa_s']:.4f}, "
          f"mixed_load_small_request_s {lat['mixed_load_small_request_s']:.4f} (idle baseline "
          f"{lat['idle_baseline_s']:.4f}); group sizes of the 4 concurrent requests {sizes}; phase "
          f"{time.perf_counter() - t_phase:.1f} s; on {card}")
    print(f"serving: K1 launches per group {k1} over {len(groups)} groups (expected {per_group}: "
          f"{SERVE_STEPS - 1} RK4 intervals x 4 evaluations x {model.dit_cfg.depth} layers); "
          f"launches over the phase {launched}")
    if k1 != [per_group] or any(g[2] for g in groups):
        raise AssertionError(f"K1 launches per group {k1} (K1-f32 {[g[2] for g in groups]}), expected {per_group}")
    _served_group_check(model, calls)
    return launched, lat


def _served_group_check(model, calls) -> None:
    """The largest group of the four concurrent requests, as the batcher
    called sample(), against the same call with K1's plain version in place
    of the kernel: the relative L2 of each row's generated mel frames and
    wave samples. The same call with each row's key mask taken from the
    next row must miss the tolerance, so a kernel that mixed up the rows'
    masks could not pass."""
    from unittest import mock

    import torch

    from f5_tts_tpu_torch.ops import flash_attention as fa

    args, kw, (wave, traj) = max(calls, key=lambda c: len(c[1]["duration"]))
    durations, lens, hop = kw["duration"], kw["lens"], model.audio_cfg.hop_length
    if not set(durations.tolist()) <= set(SERVE_FRAMES):
        raise AssertionError(f"the group's durations {durations} are not those of the serving kernel case")

    def rel_errs(want_wave, want_traj) -> dict:
        return _rows_rel_l2((wave, traj), (want_wave, want_traj), lens.tolist(), durations.tolist(), hop)

    def plain(roll):
        def attention(q, k, v, scale, key_mask=None, rope=None):
            mask = key_mask if key_mask is None or not roll else key_mask.roll(1, 0)
            return fa.flash_attention_plain(q, k, v, scale, mask, rope)

        with mock.patch.object(fa, "flash_attention", attention):
            return model.sample(*args, **kw)

    errs = rel_errs(*plain(roll=False))
    wrong = rel_errs(*plain(roll=True))
    torch.cuda.synchronize()
    print(f"served group of {len(durations)} ({durations.tolist()} frames) against plain attention: largest relative "
          f"L2 of a row's mel {errs['mel']:.3e}, wave {errs['wave']:.3e} (tol {SERVE_TOL}); with each row's key "
          f"mask taken from the next row: mel {wrong['mel']:.3e}, wave {wrong['wave']:.3e}")
    if not all(errs[x] <= SERVE_TOL[x] for x in SERVE_TOL):
        raise AssertionError(f"the served group disagrees with the same call on plain attention: {errs}")
    if not any(wrong[x] > SERVE_TOL[x] for x in SERVE_TOL):
        raise AssertionError(f"the rows' key masks change the served group by less than the tolerance: {wrong}")


# ------------------------------------------------------------ 7a. export and artifact serving

ARTIFACT_BUCKET = 768  # one 256-frame bucket: the serving phase's 6 to 7.5 s requests with the 5.33 s reference
ARTIFACT_W8A8_STEPS = 4  # Euler: 3 flow evaluations bound the W8A8 export's time
DURATION_WINDOW = 1024
ARTIFACT_TEXT = "A request of {} seconds in all."
NO_MODEL_CODE = ("f5_tts_tpu_torch.models.cfm", "f5_tts_tpu_torch.models.dit", "f5_tts_tpu_torch.models.duration")
# a fresh process loads the batch-1 artifact and calls it once with the arguments the parent saved; it must
# import none of NO_MODEL_CODE and open no snapshot file
SUBPROCESS_CALL = """
import sys, time, numpy as np, torch
opened = []
sys.addaudithook(lambda ev, a: opened.append(str(a[0])) if ev == "open" else None)
from f5_tts_tpu_torch import export as E
t0 = time.perf_counter()
s, spec = E.load_sampler(sys.argv[1])
t1 = time.perf_counter()
args = [np.load(f"{sys.argv[2]}/arg{i}.npy") for i in range(7)]
wave = s.call(*args)[1]
torch.cuda.synchronize()
np.save(f"{sys.argv[2]}/wave.npy", wave.cpu().numpy())
print("LOAD", round(t1 - t0, 1), "CALL", round(time.perf_counter() - t1, 2))
print("MODULES", [m for m in sys.argv[3].split(",") if m in sys.modules])
print("SNAPSHOT", [p for p in opened if p.endswith((".safetensors", "config.json", "vocab.txt"))])
"""


# a second process exports and saves the batch-4 and the W8A8 samplers from the snapshot while this one does the
# batch-1 sampler and the duration predictor: each export and save is one CPU core's Python for a minute or more
EXPORT_CHILD = "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; chip_smoke.export_child(*sys.argv[2:])"


def _exported(label: str, export, save, path: str, card: str) -> None:
    t0 = time.perf_counter()
    exp = export()
    t1 = time.perf_counter()
    save(exp, path)
    t2 = time.perf_counter()
    print(f"{label}: export {t1 - t0:.1f} s ({len(exp.program.graph.nodes)} graph nodes), save {t2 - t1:.1f} s, "
          f"{os.path.getsize(path) / 2**20:.1f} MiB; on {card}", flush=True)


def _artifact_request(model):
    """The phase's request inputs on the card: the bundled reference
    (normalized as the server normalizes it), its mel, and the token ids of
    a 'A request of {s} seconds in all.' text for each s."""
    from f5_tts_tpu_torch import generate as gen
    from f5_tts_tpu_torch.serve import resolve_ref_payload
    from f5_tts_tpu_torch.utils.tokenizer import convert_char_to_pinyin

    ref_audio, ref_text = gen._load_ref_audio(None, None)
    ref_n, _ = resolve_ref_payload({}, (ref_audio, ref_text), model.audio_cfg.sample_rate)

    def ids_for(secs):
        return model._tokenize(convert_char_to_pinyin([ref_text + " " + ARTIFACT_TEXT.format(s) for s in secs]))

    return ref_audio, ref_text, model._mel_spec(ref_n[None]), ids_for


def export_child(snap: str, tmp: str, card: str) -> None:
    """Phase 7a's second process: export and save the batch-4 sampler
    (then `b4.done` marks it saved), then the W8A8 sampler, load that and
    hold one call to the live W8A8 path with exact launches."""
    from f5_tts_tpu_torch import export as E
    from f5_tts_tpu_torch.models.cfm import F5TTS

    model = F5TTS.from_pretrained(snap, device="cuda")
    _exported(f"sampler batch 4 (RK4 x {SERVE_STEPS}, bucket {ARTIFACT_BUCKET}, external weights; the second "
              "process)",
              lambda: E.export_sampler(model, batch=4, padded_len=ARTIFACT_BUCKET, steps=SERVE_STEPS, method="rk4",
                                       embed_weights=False),
              lambda exp, p: E.save_sampler(exp, p, model=model, extra_meta={"method": "rk4", "cfg_strength": 2.0}),
              f"{tmp}/b4.bin", card)
    Path(f"{tmp}/b4.done").touch()
    model.dit_cfg = model.dit_cfg.replace(int8_compute=True)
    path = f"{tmp}/w8a8.bin"
    _exported(f"W8A8 sampler batch 1 (Euler x {ARTIFACT_W8A8_STEPS}, external weights; the second process)",
              lambda: E.export_sampler(model, batch=1, padded_len=ARTIFACT_BUCKET, steps=ARTIFACT_W8A8_STEPS,
                                       method="euler", embed_weights=False),
              lambda exp, p: E.save_sampler(exp, p, model=model, extra_meta={"method": "euler"}), path, card)
    t0 = time.perf_counter()
    w8, spec = E.load_sampler(path)
    print(f"W8A8 sampler: load {time.perf_counter() - t0:.1f} s; on {card}", flush=True)
    _, _, cond1, ids_for = _artifact_request(model)
    evals, depth = ARTIFACT_W8A8_STEPS - 1, model.dit_cfg.depth
    _artifact_vs_live("W8A8 sampler", w8, spec, model, cond1, ids_for([7.0]), [656], card, ARTIFACT_W8A8_STEPS,
                      "euler", {**ZERO, "flash_attention_fwd": depth * evals, "w8a8_quantize": 6 * depth * evals,
                                "w8a8_rescale": 6 * depth * evals})


def _started(args: list, log: str) -> subprocess.Popen:
    """A process of this phase, its output and errors in the files
    `log`.out and `log`.err (a pipe that nobody reads can block it)."""
    with open(f"{log}.out", "w") as out, open(f"{log}.err", "w") as err:
        return subprocess.Popen([sys.executable, "-c", *args], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                                stdout=out, stderr=err, text=True)


def _finished(proc: subprocess.Popen, log: str, label: str, timeout: float = 900) -> str:
    """The output of a process `_started`, printed; its failure raises."""
    proc.wait(timeout=timeout)
    out = Path(f"{log}.out").read_text()
    print(out.rstrip(), flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"{label} failed: {Path(f'{log}.err').read_text()[-3000:]}")
    return out


def _rows_rel(mel, wave, traj, live_wave, lens, durations, hop) -> dict:
    """The largest relative L2 over the rows of the generated mel frames
    (the artifact's composite against the live ODE state) and wave samples,
    and the largest absolute differences."""
    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    rows = list(zip(lens.tolist(), durations.tolist()))
    live_wave = live_wave.reshape(len(rows), -1)
    return {"mel": max(rel(mel[i, r:d], traj[0, i, r:d]) for i, (r, d) in enumerate(rows)),
            "wave": max(rel(wave[i, r * hop:(d - 1) * hop], live_wave[i, r * hop:(d - 1) * hop])
                        for i, (r, d) in enumerate(rows)),
            "mel_abs": max((mel[i, r:d] - traj[0, i, r:d]).abs().max().item() for i, (r, d) in enumerate(rows)),
            "wave_abs": max((wave[i, r * hop:(d - 1) * hop] - live_wave[i, r * hop:(d - 1) * hop]).abs().max().item()
                            for i, (r, d) in enumerate(rows))}


def _artifact_vs_live(label, sampler, spec, model, cond, ids, durations, card, steps, method, expect) -> tuple:
    """One artifact call at seed 0 against `F5TTS.sample` at the same seed,
    steps, method, CFG, sway and bucket: the rows' differences (SERVE_TOL)
    and the call's exact launches (`expect`), with K1's plain version made
    to raise (no fallback). Returns (prep args, wave)."""
    from unittest import mock

    import numpy as np
    import torch

    from f5_tts_tpu_torch import export as E
    from f5_tts_tpu_torch.ops import flash_attention as fa

    args = E.prep_inputs(spec, cond, ids, np.asarray(durations), seed=0)
    before = counts()
    with mock.patch.object(fa, "flash_attention_plain", side_effect=AssertionError("K1 fell back to plain")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel, wave = sampler.call(*args)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in counts().items()}
    live_wave, traj = model.sample(cond, ids, duration=np.asarray(durations), steps=steps, method=method,
                                   cfg_strength=2.0, sway_sampling_coef=-1.0, seed=0, return_trajectory=False)
    errs = _rows_rel(mel, wave, traj, live_wave, args[1], args[2], model.audio_cfg.hop_length)
    print(f"{label}: artifact call {call_s:.3f} s; against F5TTS.sample (seed 0, {steps} {method} steps, CFG 2, "
          f"sway -1, bucket {spec.padded_len}): largest relative L2 of a row's mel {errs['mel']:.3e}, wave "
          f"{errs['wave']:.3e} (tol {SERVE_TOL}), largest absolute mel {errs['mel_abs']:.3e}, wave "
          f"{errs['wave_abs']:.3e}; launches {launched}; on {card}", flush=True)
    if not all(errs[x] <= SERVE_TOL[x] for x in SERVE_TOL):
        raise AssertionError(f"{label}: the artifact disagrees with the live sampler: {errs}")
    if launched != expect:
        raise AssertionError(f"{label}: launches in one artifact call {launched}, expected {expect}")
    return args, wave


def artifact_phase(card: str, snap: str, tmp_base: str | None, live_lat: dict) -> dict:
    """Export and artifact serving on the float snapshot: batch-1 and
    batch-4 samplers (RK4, 8 steps, CFG 2, external weights, the 768-frame
    bucket), the float32 duration predictor (1024-frame window) and a
    batch-1 W8A8 sampler (Euler, 4 steps; the batch-4 and W8A8 exports in a
    second process, alongside), each held to the live path with exact
    launches; a fresh process that loads and calls the batch-1 artifact
    without the model code; then `serve_artifacts` over the three
    float artifacts (four concurrent requests as one batch-4 call, a
    request the duration artifact sets, a stream, a 400) and
    serve_latency's artifact bench. Returns the kernels' launches over the
    phase."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from f5_tts_tpu_torch import export as E
    from f5_tts_tpu_torch.artifact_serve import serve_artifacts
    from f5_tts_tpu_torch.models.cfm import F5TTS
    from f5_tts_tpu_torch.serve import _pcm16
    from f5_tts_tpu_torch.tools import serve_latency

    phase("export and artifact serving: export b1/b4 (RK4 x 8), duration, W8A8 b1 (Euler x 4) -> artifact vs "
          "live, a fresh process without model code, serve_artifacts, artifact bench")
    reset_counts()
    t_phase = time.perf_counter()
    model = F5TTS.from_pretrained(snap, device="cuda")
    depth = model.dit_cfg.depth
    ref_audio, ref_text, cond1, ids_for = _artifact_request(model)
    ref_frames = cond1.shape[1]

    tmp = tempfile.mkdtemp(dir=tmp_base)
    paths = {k: f"{tmp}/{k}.bin" for k in ("b1", "b4", "duration")}
    procs = []
    try:
        exporter = _started([EXPORT_CHILD, str(ROOT), snap, tmp, card], f"{tmp}/exporter")
        procs.append(exporter)
        _exported(f"sampler batch 1 (RK4 x {SERVE_STEPS}, bucket {ARTIFACT_BUCKET}, external weights)",
                  lambda: E.export_sampler(model, batch=1, padded_len=ARTIFACT_BUCKET, steps=SERVE_STEPS,
                                           method="rk4", embed_weights=False),
                  lambda exp, p: E.save_sampler(exp, p, model=model,
                                                extra_meta={"method": "rk4", "cfg_strength": 2.0}), paths["b1"], card)
        # the fresh process loads and calls the batch-1 artifact while this one goes on
        spec1 = E.SamplerSpec(batch=1, padded_len=ARTIFACT_BUCKET, steps=SERVE_STEPS, mel_dim=100,
                              text_num_embeds=model.dit_cfg.text_num_embeds)
        args1 = E.prep_inputs(spec1, cond1.cpu().numpy(), ids_for([7.0]), 656, seed=0)
        for i, x in enumerate(args1):
            np.save(f"{tmp}/arg{i}.npy", x)
        child = _started([SUBPROCESS_CALL, paths["b1"], tmp, ",".join(NO_MODEL_CODE)], f"{tmp}/fresh")
        procs.append(child)
        predictor = model.duration_predictor
        _exported(f"duration predictor (window {DURATION_WINDOW}, float32, external weights)",
                  lambda: E.export_duration(predictor, padded_len=DURATION_WINDOW, embed_weights=False),
                  lambda exp, p: E.save_duration(exp, p, predictor=predictor), paths["duration"], card)
        while not os.path.exists(f"{tmp}/b4.done"):  # the second process goes on to the W8A8 sampler
            if exporter.poll() is not None:
                _finished(exporter, f"{tmp}/exporter", "the exporting process")
                raise AssertionError("the exporting process ended without the batch-4 sampler")
            time.sleep(0.5)

        httpd = serve_artifacts([paths["b1"], paths["b4"]], duration_artifact=paths["duration"],
                                default_ref=(ref_audio, ref_text), host="127.0.0.1", port=0, max_wait_ms=200)
        port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            s = httpd.sampler
            b1, b4 = s.pick_artifact(ARTIFACT_BUCKET, 1), s.pick_artifact(ARTIFACT_BUCKET, 4)
            float_expect = {**ZERO, "flash_attention_fwd": (SERVE_STEPS - 1) * 4 * depth}
            _, wave1 = _artifact_vs_live("sampler batch 1", b1.sampler, b1.spec, model, cond1, ids_for([7.0]),
                                         [656], card, SERVE_STEPS, "rk4", float_expect)
            cond4 = cond1.expand(4, -1, -1)
            _artifact_vs_live("sampler batch 4", b4.sampler, b4.spec, model, cond4, ids_for(SERVE_DURATIONS),
                              list(SERVE_FRAMES), card, SERVE_STEPS, "rk4", float_expect)

            # the duration artifact against the live predictor's forward over the same window
            d = s.duration
            dargs = E.prep_duration_inputs(d.spec, cond1, ids_for([7.0]), lens=np.array([ref_frames], np.int32))
            before = counts()
            seconds = float(d.sampler.call(*dargs)[0])
            launched = {k: v - before[k] for k, v in counts().items()}
            with torch.inference_mode():
                live_s = float(predictor.seconds(*(torch.as_tensor(x, device="cuda") for x in dargs))[0])
            print(f"duration artifact: {seconds:.6f} s against the live forward's {live_s:.6f} s (relative "
                  f"{abs(seconds - live_s) / live_s:.3e}, tol 1e-4); launches {launched}; on {card}")
            if abs(seconds - live_s) > 1e-4 * live_s or launched != {**ZERO, "flash_attention_fwd_f32": 8}:
                raise AssertionError("the duration artifact disagrees with the live predictor or its launches")

            _finished(exporter, f"{tmp}/exporter", "the exporting process")
            out = _finished(child, f"{tmp}/fresh", "the fresh process")
            same = np.array_equal(np.load(f"{tmp}/wave.npy"), wave1.cpu().numpy())
            print(f"fresh process: models loaded {NO_MODEL_CODE} none; wave equal to this process's to the bit: "
                  f"{same}")
            if "MODULES []" not in out or "SNAPSHOT []" not in out or not same:
                raise AssertionError("the fresh process imported model code, opened a snapshot file or gave "
                                     "another wave")

            t0 = time.perf_counter()
            s.warmup()
            print(f"artifact server warm-up: {time.perf_counter() - t0:.1f} s")
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
                health = json.loads(r.read())
            print(f"healthz: {json.dumps(health)}")
            if [(x["padded_len"], x["batch"]) for x in health["buckets"]] != [(ARTIFACT_BUCKET, 1),
                                                                               (ARTIFACT_BUCKET, 4)]:
                raise AssertionError(f"healthz: {health}")

            chunks = []  # (batch, items, direct result) of each synthesize_chunk call
            run_chunk = s.synthesize_chunk

            def recording(art, ids, refs, durs, **kw):
                out = run_chunk(art, ids, refs, durs, **kw)
                chunks.append((art, ids, refs, durs, kw, out))
                return out

            s.synthesize_chunk = recording
            bodies, errors = {}, []

            def hit(sec):
                try:
                    bodies[sec] = _ok(port, {"text": ARTIFACT_TEXT.format(sec), "duration": sec, "seed": 0},
                                      f"{sec} s artifact request")
                except Exception as e:  # re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=hit, args=(sec,)) for sec in SERVE_DURATIONS]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            conc_s = time.perf_counter() - t0
            if errors or len(bodies) != 4:
                raise AssertionError(f"concurrent artifact requests failed: {errors}")
            sizes = [(c[0].spec.batch, len(c[1])) for c in chunks]
            art, ids, refs, durs, kw, served = chunks[0]
            direct = run_chunk(art, ids, refs, durs, **kw)
            by_len = {len(w): w for w in direct}
            equal = all(_pcm16(by_len[(len(bodies[sec]) - 44) // 2]) == bodies[sec][44:] for sec in SERVE_DURATIONS)
            print(f"4 concurrent /synthesize ({', '.join(map(str, SERVE_DURATIONS))} s): {conc_s:.3f} s; artifact "
                  f"calls (batch, items) {sizes}; each answer equal to the direct batch-4 call's item: {equal}")
            if sizes != [(4, 4)] or not equal:
                raise AssertionError(f"the four requests ran as {sizes}, or an answer differs from the direct call")
            s.synthesize_chunk = run_chunk

            threads_seen = []
            dcall = d.sampler.call

            def recording_call(*args):
                threads_seen.append(threading.current_thread())
                return dcall(*args)

            d.sampler.call = recording_call
            f32_before = counts()["flash_attention_fwd_f32"]
            body = _ok(port, {"text": "The duration artifact sets this request's duration.", "seed": 0},
                       "duration-less artifact request")
            f32 = counts()["flash_attention_fwd_f32"] - f32_before
            d.sampler.call = dcall
            print(f"duration-less request: {len(body)} bytes; K1-f32 launches {f32}, predictor run in the batcher "
                  f"thread: {threads_seen == [httpd.batcher]}")
            if f32 != 8 or threads_seen != [httpd.batcher]:
                raise AssertionError("the duration-less request did not run the duration artifact once in the "
                                     "batcher thread")

            chunks_, t_first, t_end = _stream(port, {"text": STREAM_TEXT, "estimate_duration": True, "seed": 0})
            print(f"artifact stream of 3 sentences: first PCM at {t_first:.3f} s, end at {t_end:.3f} s, "
                  f"{len(chunks_) - 1} PCM chunks")
            if chunks_[0][:4] != b"RIFF" or t_first is None or not t_first < t_end or len(chunks_) != 4:
                raise AssertionError("the artifact stream's header, first PCM chunk or chunk count is wrong")
            status, body = _post(port, {"text": "hi", "speed": "fast"})
            print(f"malformed artifact request: HTTP {status} {body[:80]!r}")
            if status != 400:
                raise AssertionError(f"a malformed artifact request got HTTP {status}, not 400")

            t0 = time.perf_counter()
            bench = serve_latency.artifact_measure(port, n_requests=8)
            print(f"artifact bench ({time.perf_counter() - t0:.1f} s, 8 requests of 7 s, RK4 x {SERVE_STEPS}): "
                  f"artifact_throughput_sequential_utt_s {bench['sequential_utt_s']:.4f}, "
                  f"artifact_throughput_concurrent_b1b4_utt_s {bench['concurrent_utt_s']:.4f}; the live server's "
                  f"warm_synthesize_s {live_lat['warm_synthesize_s']:.4f}; on {card}")
            torch.cuda.synchronize()
        finally:
            httpd.batcher.stop()
            httpd.shutdown()
            httpd.batcher.join(timeout=60)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    launched = counts()
    print(f"export and artifact serving: phase {time.perf_counter() - t_phase:.1f} s; launches over the phase "
          f"{launched}; on {card}")
    # phase 7b: the batch-4 sampler the server loaded from b4.bin (load_sampler), over data-parallel grids
    grid_launched = artifact_mesh_phase(card, b4.sampler, b4.spec, depth, cond1.expand(4, -1, -1),
                                        ids_for(SERVE_DURATIONS))
    return launched, grid_launched


# phase 7b: the data axes the batch-4 sampler is placed on (data 4: one row a slot)
ARTIFACT_DATA = (2, 4)


def artifact_mesh_phase(card: str, sampler, spec, depth: int, cond, ids) -> dict:
    """Phase 7b: the loaded batch-4 sampler (RK4 x 8, external weights)
    called on the card as loaded, on each data row's share of its four
    requests, then placed over data 2 and data 4 of `mesh_devices()` (the
    card repeated where there are fewer than four): each data row's rows
    equal to the bit to the one-device call on its share, the batch within
    SERVE_TOL of the one-device batch, exact K1 launches with K1's plain
    version made to raise; then `place_weights("cuda")` to the bit, and a
    model axis of 2 refused. Returns the grid calls' launches."""
    from unittest import mock

    import numpy as np
    import torch

    from f5_tts_tpu_torch import export as E
    from f5_tts_tpu_torch.ops import flash_attention as fa
    from f5_tts_tpu_torch.parallel.mesh import create_mesh, pad_batch

    devices = mesh_devices()
    axes = " and ".join(map(str, ARTIFACT_DATA))
    phase(f"artifact over data-parallel grids: the batch-4 sampler placed on data {axes} of "
          f"{'the one card repeated' if devices else 'distinct cards'}, each data row against its share, "
          "place_weights('cuda'), a model axis refused")
    t_phase = time.perf_counter()
    args = E.prep_inputs(spec, cond, ids, np.asarray(SERVE_FRAMES), seed=0)
    lens, durations, hop = args[1], args[2], spec.hop_length
    k1 = (SERVE_STEPS - 1) * 4 * depth  # a flow evaluation a stage, each DiT block once

    def timed(call_args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler.call(*call_args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (mel1, wave1), one_s = timed(args)
    shares = {}
    for data in ARTIFACT_DATA:
        padded = [pad_batch(torch.as_tensor(a), data) if i in E._BATCHED else a for i, a in enumerate(args[:6])]
        n = padded[0].shape[0] // data
        shares[data] = [timed([a[r * n:(r + 1) * n] if i in E._BATCHED else a for i, a in enumerate(padded)]
                              + [args[6]]) for r in range(data)]
    print(f"one device: the batch-4 call {one_s:.3f} s; each data row's share alone: "
          + "; ".join(f"data {data} " + ", ".join(f"{s:.3f}" for _, s in calls) + " s"
                      for data, calls in shares.items()) + f"; on {card}", flush=True)

    reset_counts()
    walls = {}
    for data in ARTIFACT_DATA:
        grid = create_mesh(data=data, devices=None if devices is None else devices[:data])
        t0 = time.perf_counter()
        sampler.place_weights(grid)
        place_s = time.perf_counter() - t0
        before = counts()
        with mock.patch.object(fa, "flash_attention_plain", side_effect=AssertionError("K1 fell back to plain")):
            (mel, wave), walls[data] = timed(args)
        launched = {k: v - before[k] for k, v in counts().items()}
        n = -(-4 // data)
        exact = [torch.equal(mel[r * n:(r + 1) * n], m[:n]) and torch.equal(wave[r * n:(r + 1) * n], w[:n])
                 for r, ((m, w), _) in enumerate(shares[data])]
        errs = _rows_rel_l2((wave, mel[None]), (wave1, mel1[None]), lens.tolist(), durations.tolist(), hop)
        copies = len(sampler._weights_dev)
        print(f"data {data} on {grid}: place_weights {place_s:.3f} s ({copies} weight "
              f"cop{'y' if copies == 1 else 'ies'}); call {walls[data]:.3f} s against one device's {one_s:.3f} s "
              f"({walls[data] / one_s:.2f}x); each data row's rows equal to the bit to its share alone: {exact}; "
              f"against the one-device batch of 4: "
              f"largest relative L2 of a row's mel {errs['mel']:.3e}, wave {errs['wave']:.3e} (tol {SERVE_TOL}); "
              f"launches {launched}", flush=True)
        expect = {**ZERO, "flash_attention_fwd": k1 * data}
        if not all(exact) or launched != expect or not all(errs[x] <= SERVE_TOL[x] for x in SERVE_TOL):
            raise AssertionError(f"data {data}: rows to the bit {exact}, launches {launched} (expected {expect}), "
                                 f"against one device {errs}")
    grid_launched = counts()

    sampler.place_weights("cuda")
    mel, wave = sampler.call(*args)
    same = torch.equal(mel, mel1) and torch.equal(wave, wave1)
    try:
        sampler.place_weights(create_mesh(data=1, model=2, devices=None if devices is None else devices[:2]))
    except ValueError as e:
        refused = str(e)
    else:
        refused = None
    print(f"place_weights('cuda') after the grids: equal to the one-device call to the bit: {same}; a model axis of "
          f"2: ValueError {refused!r}")
    if not same or refused is None or "not tensor-partitioned" not in refused:
        raise AssertionError("place_weights('cuda') changed the output, or a model axis was not refused")
    print(f"artifact over data-parallel grids: phase {time.perf_counter() - t_phase:.1f} s; launches of the grid "
          f"calls {grid_launched}; on {card}")
    return grid_launched


def _attention_grad_case(gen, name: str, dtype, b: int, h: int, n: int, d: int, lens) -> dict:
    """K1 with its log-sum-exp and K2 on one case against their plain
    versions, on q, k, v and g drawn as [b, n, h*d] projection views with
    RoPE, as the trainers' attention takes them. `lens` is None (no key
    mask, as in the training forward) or the valid keys, one count for
    every row or one per row. Prints the errors, raises on a disagreement
    and returns the case's tensors and errors."""
    import torch

    from f5_tts_tpu_torch.models.rope import rotary_freqs
    from f5_tts_tpu_torch.ops import flash_attention as fa

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    q, k, v, g = (torch.randn(b, n, h * d, generator=gen, device="cuda").to(dtype).view(b, n, h, d).transpose(1, 2)
                  for _ in range(4))
    mask = None
    if lens is not None:
        mask = (torch.arange(n, device="cuda")[None, :]
                < torch.tensor(lens, device="cuda").reshape(-1, 1)).expand(b, n).contiguous()
    raw = rotary_freqs(n, d, device="cuda")
    rope = (torch.cos(raw), torch.sin(raw))
    scale = d ** -0.5
    key_mask, cos, sin = fa._checked(q, k, v, mask, rope)
    out, lse = fa._forward_kernel(q, k, v, scale, key_mask, cos, sin, with_lse=True)
    out_err = (out.float() - fa.flash_attention_plain(q, k, v, scale, mask, rope).float()).abs().max().item()
    out_tol = ATTN_TOL if tag == "bf16" else F32_TOL
    lse_err = (lse - fa.attention_lse_plain(q, k, scale, mask, rope)).abs().max().item()
    lse_tol = 2e-2 if tag == "bf16" else F32_TOL
    got = fa._backward_kernel(q, k, v, out, lse, g, scale, key_mask, cos, sin)
    ref = fa.flash_attention_bwd_plain(q, k, v, out, g, scale, mask, rope)
    torch.cuda.synchronize()
    if any(a.dtype != dtype for a in got):
        raise AssertionError(f"the backward kernel wrote {[a.dtype for a in got]}, expected {dtype}")
    abs_errs = [(a.float() - r).abs().max().item() for a, r in zip(got, ref)]
    errs = [e / r.abs().max().item() for e, r in zip(abs_errs, ref)]
    shown = lens if lens is None or isinstance(lens, int) else list(lens)
    print(f"{name}: {tag} [b={b}, h={h}, n={n}, d={d}] mask={shown} rope=True strided=True: "
          f"max|kernel - plain| / max|plain| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
          f"(tol {GRAD_TOL[tag]}); forward max error {out_err:.3e} (tol {out_tol}); "
          f"lse max error {lse_err:.3e} (tol {lse_tol})")
    if not max(errs) <= GRAD_TOL[tag]:
        raise AssertionError(f"attention backward kernel disagrees with its plain version at {name}: {errs}")
    if not out_err <= out_tol:
        raise AssertionError(f"the forward kernel disagrees with its plain version at {name}: {out_err}")
    if not lse_err <= lse_tol:
        raise AssertionError(f"the forward's log-sum-exp disagrees with the plain one at {name}: {lse_err}")
    return {"q": q, "k": k, "v": v, "g": g, "out": out, "lse": lse, "got": got, "mask": mask, "rope": rope,
            "scale": scale, "key_mask": key_mask, "cos": cos, "sin": sin, "abs_errs": abs_errs}


def bwd_kernel_phase():
    import torch

    from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb
    from f5_tts_tpu_torch.ops import flash_attention as fa

    phase("attention backward vs plain (bf16 and float32), and the forward's log-sum-exp")
    gen = torch.Generator(device="cuda").manual_seed(2)
    # (name, dtype, b, h, n, d, valid keys or None): q, k, v and g as [b, n, h*d] projection views, RoPE
    cases = [
        ("CFM training", torch.bfloat16, TRAIN_BATCH, 16, TRAIN_FRAMES, 64, None),
        ("key mask, ragged n", torch.bfloat16, TRAIN_BATCH, 16, 937, 64, 900),
        ("duration training", torch.float32, TRAIN_BATCH, 8, TRAIN_FRAMES, 64, None),
    ]
    results = {}
    for name, dtype, b, h, n, d, valid in cases:
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        c = _attention_grad_case(gen, name, dtype, b, h, n, d, valid)
        q, k, v, g, out, lse, got = c["q"], c["k"], c["v"], c["g"], c["out"], c["lse"], c["got"]
        mask, rope, scale, key_mask, cos, sin = c["mask"], c["rope"], c["scale"], c["key_mask"], c["cos"], c["sin"]
        ms = _time_ms(lambda: fa._backward_kernel(q, k, v, out, lse, g, scale, key_mask, cos, sin))
        plain_ms = _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, g, scale, mask, rope), iters=5)
        flop = 10 * b * h * n * n * d
        print(f"{name}: kernel {ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s at 10 b h n^2 d, "
              f"{1.4 * flop / ms / 1e9:.1f} at the 14 b h n^2 d executed), plain {plain_ms:.4f} ms")
        # yardstick: the backward of SDPA on q and k already rotated, with the same mask; bound:
        # 10 b h n n_keys d operations, q, k, v, out, g and lse read and dq, dk, dv written once
        leaves = [t.detach().requires_grad_() for t in
                  (apply_rotary_pos_emb(q, rope), apply_rotary_pos_emb(k, rope), v)]
        sdpa_out = _sdpa(*leaves, scale, mask)
        library_ms = _time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True), iters=5)
        bound_ms, bound_by = bound(10 * b * h * n * (valid or n) * d,
                                   nbytes(q, k, v, out, g, lse, mask, *rope, *got), tag)
        _library_line(name, "SDPA backward, RoPE outside", library_ms, bound_ms, bound_by)
        results[name] = {"err": max(c["abs_errs"]), "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
    return results


def _train_batch(gen, mel_dim=100):
    """A synthetic batch: mel frames past each length zeroed, as the loader
    pads them; text ids of the vocab's range padded with -1."""
    import torch

    b = TRAIN_BATCH
    lens = torch.tensor(TRAIN_LENS, device="cuda")[:b]
    n = TRAIN_FRAMES
    mel = torch.randn(b, n, mel_dim, generator=gen, device="cuda")
    mel = torch.where((torch.arange(n, device="cuda")[None, :] < lens[:, None])[..., None], mel, 0.0)
    text = torch.randint(0, len(VOCAB_CHARS), (b, 240), generator=gen, device="cuda", dtype=torch.int32)
    text[1:, 200:] = -1
    return mel, text, lens


def _train_steps(name, step_fn, state, batch, draws, expect, n_steps, card):
    """One warm-up step and `n_steps` timed ones on a fixed batch and fixed
    draws; checks each step's kernel launches against `expect` and that the
    loss is finite and falls. Returns (losses, ms per timed step)."""
    import torch

    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_steps + 1):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step_fn(state, *batch, draws=draws)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = {k: v - before[k] for k, v in counts().items()}
        if launched != expect:
            raise AssertionError(f"{name} step {i}: kernel launches {launched}, expected {expect}")
        losses.append(loss.item())
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"{name} step {i}: loss {losses[-1]}")
    ms = [t * 1e3 for t in times[1:]]
    median = sorted(ms)[len(ms) // 2]
    print(f"{name}: losses {', '.join(f'{x:.4f}' for x in losses)}; step ms after the warm-up "
          f"{', '.join(f'{t:.1f}' for t in ms)}; median {median:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_FRAMES / (median / 1e3):.0f} frames/s; launches per step {expect}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall ({losses[0]} -> {losses[-1]})")
    return losses, ms


def cfm_training_phase(card: str, tmp: str):
    import torch

    from f5_tts_tpu_torch import F5TTS, CFMConfig
    from f5_tts_tpu_torch.config import F5TTS_V1_BASE
    from f5_tts_tpu_torch.models.cfm import cfm_loss, draw_cfm
    from f5_tts_tpu_torch.models.dit import DiT
    from f5_tts_tpu_torch.training import trainer as T

    phase(f"CFM training: base DiT, float32 master + bf16 compute, AdamW + EMA, {TRAIN_BATCH} x {TRAIN_FRAMES} frames")
    gen = torch.Generator(device="cuda").manual_seed(3)
    cfg = F5TTS_V1_BASE.replace(compute_dtype="bfloat16")
    model = F5TTS.init(gen, cfg, device="cuda", cfm_cfg=CFMConfig())
    opt = T.make_optimizer(learning_rate=1e-4, num_warmup_steps=0, total_steps=1000)
    state = T.init_train_state(model.dit, opt, ema=True)
    watched = {k: p.detach().clone() for k, p in list(model.dit.named_parameters())[-4:]}
    mel, text, lens = _train_batch(gen)
    draws = draw_cfm(gen, model.cfm_cfg, TRAIN_BATCH, TRAIN_FRAMES, 100, torch.device("cuda"))
    print(f"DiT parameters {sum(p.numel() for p in model.dit.parameters())}; CFG drops of the fixed draws: "
          f"audio {bool(draws.audio_drop[0] < model.cfm_cfg.audio_drop_prob)}, "
          f"text {bool(draws.text_drop[0] < model.cfm_cfg.cond_drop_prob)}")

    per_micro = {**ZERO, "flash_attention_fwd": cfg.depth, "flash_attention_bwd": cfg.depth}
    reset_counts()
    step = T.make_train_step(model.cfm_cfg, opt, ema_decay=0.999)
    losses, ms = _train_steps("CFM step", step, state, (mel, text, lens), draws, per_micro, 8, card)
    half = TRAIN_BATCH // 2
    draws2 = [draw_cfm(gen, model.cfm_cfg, half, TRAIN_FRAMES, 100, torch.device("cuda")) for _ in range(2)]
    before = counts()
    t0 = time.perf_counter()
    loss2 = T.make_train_step(model.cfm_cfg, opt, ema_decay=0.999, grad_accum=2)(
        state, *T.split_microbatches(2, mel, text, lens), draws=draws2).item()
    accum_ms = (time.perf_counter() - t0) * 1e3
    launched = counts()
    accum = {k: v - before[k] for k, v in launched.items()}
    expect2 = {k: 2 * v for k, v in per_micro.items()}
    print(f"grad_accum=2 step: loss {loss2:.4f}, {accum_ms:.1f} ms, launches {accum}")
    if accum != expect2 or not math.isfinite(loss2):
        raise AssertionError(f"grad_accum=2 step: launches {accum} (expected {expect2}), loss {loss2}")
    if state.step != 10 or state.opt_state["count"] != 10:
        raise AssertionError(f"update count {state.step}, expected 10")
    params = dict(model.dit.named_parameters())
    for k, p in watched.items():
        if torch.equal(p, params[k]) or torch.equal(p, state.ema[k]):
            raise AssertionError(f"{k}: the parameter or its EMA did not move")

    phase("CFM training: save_checkpoint / load_checkpoint round trip")
    t0 = time.perf_counter()
    trainer = T.F5TTSTrainer(model, results_dir=tmp, ema_decay=0.999)
    trainer.state = state
    trainer.save_checkpoint(state.step)
    t1 = time.perf_counter()
    fresh = T.F5TTSTrainer(F5TTS.init(torch.Generator(device="cuda").manual_seed(4), cfg, device="cuda"),
                           results_dir=tmp, ema_decay=0.999)
    fresh.state = T.init_train_state(fresh.model.dit, opt, ema=True)
    fresh.load_checkpoint(state.step)
    torch.cuda.synchronize()
    loaded = dict(fresh.model.dit.named_parameters())
    for k, p in params.items():
        if not (torch.equal(loaded[k], p) and torch.equal(fresh.state.ema[k], state.ema[k])
                and torch.equal(fresh.state.opt_state["mu"][k], state.opt_state["mu"][k])
                and torch.equal(fresh.state.opt_state["nu"][k], state.opt_state["nu"][k])):
            raise AssertionError(f"checkpoint round trip changed {k}")
    if fresh.state.step != state.step or fresh.state.opt_state["count"] != state.opt_state["count"]:
        raise AssertionError("checkpoint round trip lost the step")
    print(f"save {t1 - t0:.1f} s, load {time.perf_counter() - t1:.1f} s: weights, EMA, moments and step "
          f"{fresh.state.step} identical; files "
          + ", ".join(f"{f.name} {f.stat().st_size / 2**20:.0f} MiB" for f in sorted(Path(tmp).glob("*"))))
    del fresh, loaded

    phase("CFM training: the gradient on the card (bf16 compute) against the float32 CPU path")
    g_cpu = torch.Generator().manual_seed(5)
    b, n = 2, 128
    small = (torch.randn(b, n, 100, generator=g_cpu), torch.randint(0, 95, (b, 40), generator=g_cpu),
             torch.tensor([n, 100]))
    small_draws = draw_cfm(g_cpu, model.cfm_cfg, b, n, 100, torch.device("cpu"))
    dit_cpu = DiT(cfg.replace(compute_dtype="float32"))
    dit_cpu.load_state_dict(model.dit.state_dict())
    flat = []
    for dit, dev in ((model.dit, "cuda"), (dit_cpu, "cpu")):
        moved = type(small_draws)(**{k: v.to(dev) for k, v in vars(small_draws).items()})
        loss = cfm_loss(dit, model.cfm_cfg, *(t.to(dev) for t in small), draws=moved)
        grads = torch.autograd.grad(loss, list(dit.parameters()))
        flat.append(torch.cat([g.float().cpu().reshape(-1) for g in grads]))
    rel = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
    print(f"relative L2 of the card's gradient (bf16 compute) against the float32 CPU path: {rel:.3e} "
          f"(tol {TRAIN_GRAD_TOL})")
    if not rel <= TRAIN_GRAD_TOL:
        raise AssertionError(f"the DiT's gradient on the card disagrees with the CPU path: {rel}")
    return losses, ms, launched


def duration_training_phase(card: str):
    import torch

    from f5_tts_tpu_torch.config import DURATION_V2
    from f5_tts_tpu_torch.models.duration import DurationPredictor
    from f5_tts_tpu_torch.training import trainer as T
    from f5_tts_tpu_torch.training.duration_trainer import make_duration_train_step

    phase(f"duration training: DURATION_V2, float32, {TRAIN_BATCH} x {TRAIN_FRAMES} frames")
    gen = torch.Generator(device="cuda").manual_seed(6)
    model = DurationPredictor.init(gen, DURATION_V2, device="cuda")
    opt = T.make_optimizer(learning_rate=1e-4, num_warmup_steps=0, total_steps=1000)
    state = T.init_train_state(model, opt, ema=True)
    mel, text, lens = _train_batch(gen)
    rand_frac = torch.rand(TRAIN_BATCH, generator=gen, device="cuda")
    per_step = {**ZERO, "flash_attention_fwd_f32": DURATION_V2.depth, "flash_attention_bwd_f32": DURATION_V2.depth}
    reset_counts()
    step = make_duration_train_step(opt, model.audio_cfg.frames_per_second, ema_decay=0.999)
    losses, ms = _train_steps("duration step", step, state, (mel, text, lens), rand_frac, per_step, 4, card)
    return losses, ms, counts()


WAV_CLIPS = 32  # 16-bit mono 24 kHz, 2.0 to 9.99 s: 187 to 936 frames, the buckets 256 to 1024
WAV_MAX_DURATION = 10
WAV_WORDS = ("some", "call", "me", "nature", "others", "mother", "the", "quick", "brown", "fox", "jumped",
             "over", "lazy", "dog", "and", "then", "it", "ends", "here", "again")


def write_wav_tree(root: Path) -> dict:
    """A LibriTTS-layout tree (<speaker>/<chapter>/<id>.wav beside
    <id>.normalized.txt) from numpy seed 0: WAV_CLIPS 16-bit clips, one
    24-bit and one float32 clip, and three files that must not reach a
    batch: a 16 kHz clip (dropped by decode), a file that is not a WAV
    (dropped by decode) and a clip longer than WAV_MAX_DURATION (dropped by
    the scan). Returns {stem: seconds} of the clips a batch may hold."""
    import numpy as np

    from f5_tts_tpu_torch.audio.io import write_wav_format

    rng = np.random.default_rng(0)
    kept = {}

    def clip(name, seconds, fmt="pcm16", rate=24_000, keep=True):
        d = root / str(100 + len(kept) % 4) / str(2000 + len(kept) % 3)
        d.mkdir(parents=True, exist_ok=True)
        n = int(seconds * rate)
        t = np.arange(n) / rate
        wave = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) + 0.05 * rng.standard_normal(n)
        write_wav_format(d / f"{name}.wav", wave.astype(np.float32), rate, fmt)
        words = rng.choice(WAV_WORDS, size=max(2, int(2.5 * seconds)))
        (d / f"{name}.normalized.txt").write_text(" ".join(words).capitalize() + ".")
        if keep:
            kept[name] = seconds
        return d

    for i, seconds in enumerate(np.linspace(2.0, 9.99, WAV_CLIPS)):  # 10.0 s reads 10.0009 with its header
        clip(f"clip_{i:02d}", float(seconds))
    clip("deep_24bit", 3.0, "pcm24")  # the scan reads 4.5 s from its size
    clip("ieee_float", 4.0, "float32")  # 8.0 s from its size
    clip("rate_16k", 3.0, rate=16_000, keep=False)
    d = clip("too_long", 11.0, keep=False)
    (d / "not_a_wav.wav").write_bytes(b"this file is not a RIFF/WAVE file " * 400)
    (d / "not_a_wav.normalized.txt").write_text("Not a wave.")
    return kept


class TimedPipeline:
    """Iterates a pipeline for a trainer, timing every next() (the step's
    data wait) and the time the trainer holds each batch (its step wall,
    from one yield to the next next(); the last ends when the trainer closes
    the pipeline), and recording each batch's frame count and lengths."""

    def __init__(self, stream, hop: int = 256):
        self.stream, self.hop = stream, hop
        self.waits, self.walls, self.frames, self.lens = [], [], [], []

    def __iter__(self):
        it = iter(self.stream)
        held = None
        try:
            while True:
                t0 = time.perf_counter()
                if held is not None:
                    self.walls.append(t0 - held)
                    held = None
                try:
                    batch = next(it)
                except StopIteration:
                    return
                held = time.perf_counter()
                self.waits.append(held - t0)
                self.frames.append(batch["audio"].shape[1] // self.hop if "audio" in batch
                                   else batch["mel_spec"].shape[1])
                self.lens.append([int(x) for x in batch["mel_len"]])
                yield batch
        finally:
            if held is not None:
                self.walls.append(time.perf_counter() - held)
            it.close()

    def summary(self, label: str, card: str, routes: dict) -> dict:
        """Prints and returns the data wait's median and largest over every
        step, and the step wall's median after the first step (the warm-up);
        a wall is marked * where its bucket is seen for the first time."""
        med = lambda xs: sorted(xs)[len(xs) // 2]
        walls = self.walls[1:] or self.walls
        out = {"data_wait_ms_median": med(self.waits) * 1e3, "data_wait_ms_max": max(self.waits) * 1e3,
               "step_wall_ms_median": med(walls) * 1e3, "buckets": sorted(set(self.frames)), "decoded": routes,
               "first_lens": {n: self.lens[self.frames.index(n)] for n in sorted(set(self.frames))},
               "walls_by_bucket": {n: [w * 1e3 for w, m in zip(self.walls[1:], self.frames[1:]) if m == n]
                                   for n in sorted(set(self.frames[1:]))}}
        first = [n not in self.frames[:i] for i, n in enumerate(self.frames)]
        print(f"{label}: data wait per step median {out['data_wait_ms_median']:.2f} ms, largest "
              f"{out['data_wait_ms_max']:.2f} ms (each: {', '.join(f'{w * 1e3:.2f}' for w in self.waits)}); "
              f"step wall median after the first step {out['step_wall_ms_median']:.1f} ms (each, frames: "
              + ", ".join(f"{w * 1e3:.1f} at {n}{'*' if f else ''}" for w, n, f in zip(self.walls, self.frames, first))
              + f"; * a bucket's first step); buckets {out['buckets']}; clips decoded native {routes['native']}, "
              f"python {routes['python']}; on {card}")
        return out


def _trained(label: str, trainer, pipeline, card: str, expect: dict, steps: int, **train_kw) -> dict:
    """Runs `trainer.train` over a timed `pipeline` for `steps` steps (a
    loss logged every step, the trainer's stdout kept and printed) and
    checks the kernels' launches against `expect`, a finite loss every step,
    the update count and that every clip went through the native decoder."""
    import contextlib
    import io

    from f5_tts_tpu_torch.data import libritts

    timed = TimedPipeline(pipeline)
    libritts.reset_decode_routes()
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer.train(timed, total_steps=steps, log_every=1, **train_kw)
    launched, routes = counts(), libritts.decode_routes()
    print(out.getvalue().rstrip())
    losses = [float(line.split("loss ")[1].split()[0]) for line in out.getvalue().splitlines()
              if line.startswith("step ")]
    summary = timed.summary(label, card, routes)
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses {losses}, expected {steps} finite ones")
    if trainer.state.step != steps or trainer.state.opt_state["count"] != steps:
        raise AssertionError(f"{label}: update count {trainer.state.step}, expected {steps}")
    if launched != expect:
        raise AssertionError(f"{label}: kernel launches {launched}, expected {expect}")
    if routes["python"] or not routes["native"]:
        raise AssertionError(f"{label}: clips decoded by route {routes}; every clip must take the native decoder")
    return {"launches": launched, "losses": losses, **summary}


def _archive_scan_check(root: Path, archive_root: Path) -> None:
    """The WAV tree as a LibriTTS-R split's archive already on disk: tarred
    as LibriTTS_R/dev-clean and gzipped to dev_clean.tar.gz under
    `archive_root`; load_libritts_r must gunzip it (the .gz removed),
    extract it and scan the samples load_dir scans on the tree."""
    import gzip
    import tarfile

    from f5_tts_tpu_torch.data import load_dir, load_libritts_r

    t0 = time.perf_counter()
    archive_root.mkdir()
    tar = archive_root / "dev_clean.tar"
    with tarfile.open(tar, "w") as t:
        t.add(root, arcname="LibriTTS_R/dev-clean")
    with open(tar, "rb") as fin, gzip.open(f"{tar}.gz", "wb") as fout:
        shutil.copyfileobj(fin, fout)
    tar.unlink()
    size = Path(f"{tar}.gz").stat().st_size
    t1 = time.perf_counter()
    stream, path = load_libritts_r(archive_root, "dev-clean", max_duration=WAV_MAX_DURATION)
    t2 = time.perf_counter()
    got = [(s["file"].relative_to(path), s["transcript_file"].relative_to(path)) for s in stream]
    want = [(s["file"].relative_to(root), s["transcript_file"].relative_to(root))
            for s in load_dir(root, max_duration=WAV_MAX_DURATION)]
    gunzipped = tar.is_file() and not Path(f"{tar}.gz").exists()
    print(f"LibriTTS-R archive on disk: dev_clean.tar.gz of {size / 2**20:.1f} MiB written in {t1 - t0:.2f} s; "
          f"load_libritts_r gunzipped (the .gz removed: {gunzipped}), extracted and scanned it in {t2 - t1:.2f} s: "
          f"{len(got)} samples, the same as load_dir on the tree: {got == want}")
    if not gunzipped or got != want or not got:
        raise AssertionError(f"load_libritts_r on the archive scanned {len(got)} samples against load_dir's "
                             f"{len(want)}, or left the .gz")


def wav_training_phase(card: str, tmp_base: str | None) -> dict:
    """Training from a directory of WAV files: load_dir ->
    make_training_pipeline -> F5TTSTrainer.train (the base DiT, bf16
    compute, on-device mel, 6 steps of grad_accum=2, then 2 such steps on
    the host-mel pipeline) and DurationTrainer.train (DURATION_V2 in float32,
    host mel, 2 steps), each run's data wait and step wall timed; then K1
    and K2 against their plain versions at each bucket the runs saw, and one
    loader_bench line. Before the runs, the tree is also tarred and gzipped
    as a LibriTTS-R split's archive, which load_libritts_r must scan as
    load_dir scans the tree. Returns the kernels' launches summed over the
    runs."""
    import torch

    from f5_tts_tpu_torch import F5TTS, CFMConfig
    from f5_tts_tpu_torch.config import DURATION_V2, F5TTS_V1_BASE
    from f5_tts_tpu_torch.data import load_dir, make_training_pipeline
    from f5_tts_tpu_torch.models.duration import DurationPredictor
    from f5_tts_tpu_torch.ops import native
    from f5_tts_tpu_torch.tools import loader_bench
    from f5_tts_tpu_torch.training import DurationTrainer, F5TTSTrainer

    phase("training from a WAV directory: load_dir -> make_training_pipeline -> F5TTSTrainer / DurationTrainer")
    t0 = time.perf_counter()
    native.library()  # the g++ build, here rather than inside the first decode
    print(f"native WAV decoder {native.library_path().relative_to(ROOT)} ready in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(dir=tmp_base) as tmp:
        root, results = Path(tmp) / "wavs", Path(tmp) / "results"
        kept = write_wav_tree(root)
        print(f"WAV tree: {len(kept)} clips of {min(kept.values()):.2f} to {max(kept.values()):.2f} s "
              f"({sum(kept.values()):.1f} s of audio) and three to be dropped")
        _archive_scan_check(root, Path(tmp) / "archive")
        cfg = F5TTS_V1_BASE.replace(compute_dtype="bfloat16")
        model = F5TTS.init(torch.Generator(device="cuda").manual_seed(7), cfg, device="cuda", cfm_cfg=CFMConfig())
        trainer = F5TTSTrainer(model, num_warmup_steps=2, results_dir=str(results), ema_decay=0.999)

        def pipeline(on_device_mel):
            return make_training_pipeline(load_dir(root, max_duration=WAV_MAX_DURATION), batch_size=4, epochs=2,
                                          shuffle_buffer=32, num_threads=6, seed=0, on_device_mel=on_device_mel)

        per_micro = {**ZERO, "flash_attention_fwd": cfg.depth, "flash_attention_bwd": cfg.depth}
        cfm = _trained("CFM from WAVs, on-device mel", trainer, pipeline(True), card,
                       {k: 12 * v for k, v in per_micro.items()}, 6, save_every=6, sample_every=10**9,
                       on_device_mel=True, grad_accum=2)
        for name in ("f5tts_6.safetensors", "f5tts_6.ema.safetensors", "f5tts_6.trainstate.safetensors"):
            if not (results / name).is_file():
                raise AssertionError(f"the step-6 checkpoint file {name} was not written")
        if len(cfm["buckets"]) < 2:
            raise AssertionError(f"the CFM run saw the buckets {cfm['buckets']}; at least two are needed")
        print("step-6 checkpoint: " + ", ".join(f"{f.name} {f.stat().st_size / 2**20:.0f} MiB"
                                                for f in sorted(results.glob("*"))))
        shutil.rmtree(results)
        host = _trained("CFM from WAVs, host mel", F5TTSTrainer(model, num_warmup_steps=2, results_dir=str(results)),
                        pipeline(False), card, {k: 4 * v for k, v in per_micro.items()}, 2,
                        save_every=10**9, sample_every=10**9, grad_accum=2)
        print("CFM step wall by bucket, each trainer's first step left out (ms): on-device mel "
              f"{json.dumps(cfm['walls_by_bucket'])}, host mel {json.dumps(host['walls_by_bucket'])}; on {card}")
        del model, trainer
        torch.cuda.empty_cache()

        dur_model = DurationPredictor.init(torch.Generator(device="cuda").manual_seed(8), DURATION_V2, device="cuda")
        per_step = {**ZERO, "flash_attention_fwd_f32": DURATION_V2.depth,
                    "flash_attention_bwd_f32": DURATION_V2.depth}
        dur = _trained("duration from WAVs, host mel", DurationTrainer(dur_model, num_warmup_steps=2,
                                                                       results_dir=str(results)),
                       pipeline(False), card, {k: 2 * v for k, v in per_step.items()}, 2, save_every=10**9)
        del dur_model

    # K1 with its log-sum-exp and K2 against their plain versions at the shapes these runs gave them:
    # for each run and bucket, the first batch's first microbatch, with no key mask (as the training
    # forward calls them) and with the microbatch's lengths as per-row key masks; a microbatch is
    # batch_size // grad_accum rows: 2 in the CFM runs (grad_accum=2), 4 in the duration run
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, run, dtype, heads, head_dim, micro in (
            ("CFM on-device mel", cfm, torch.bfloat16, cfg.heads, cfg.dim_head, 2),
            ("CFM host mel", host, torch.bfloat16, cfg.heads, cfg.dim_head, 2),
            ("duration", dur, torch.float32, DURATION_V2.heads, DURATION_V2.dim_head, 4)):
        for n, lens in run["first_lens"].items():
            rows = lens[:micro]
            for mask in (None, rows):
                _attention_grad_case(gen, f"{label} at the bucket n={n}", dtype, len(rows), heads, n, head_dim,
                                     mask)

    bench = loader_bench.measure(clips=64, seconds=6, threads=8)
    print(f"loader_bench.measure(clips=64, seconds=6, threads=8), this machine's host CPU ({os.cpu_count()} cores), "
          f"beside {card}: {json.dumps(bench)}")
    runs = (cfm, host, dur)
    return {k: sum(r["launches"][k] for r in runs) for k in ZERO}


MESH_TRAIN = {"data": 2, "model": 2}
# phase 10b's limits. The base DiT in bf16, sharded against unsharded on the card: the loss's relative
# difference, the gradient's relative L2, and the share of parameters whose update agrees within lr / 10 (Adam's
# first update is about lr * sign(g): a gradient that bf16 noise moves across zero flips its update). The float32
# witness and the duration predictor are held to the JAX suite's 2e-5 on the loss and the gradient.
MESH_TRAIN_TOL = {"loss": 1e-2, "grad": 5e-2, "updates": 0.9}
WITNESS_TOL = {"loss": 2e-5, "grad": 2e-5, "updates": 0.999}
WITNESS_DEPTH = 4
MESH_TRAIN_LR = 1e-4


def _rel_l2(got: dict, want: dict) -> float:
    import torch

    num = sum(float(torch.sum((got[k].float() - w.float()) ** 2)) for k, w in want.items())
    den = sum(float(torch.sum(w.float() ** 2)) for w in want.values())
    return math.sqrt(num / den)


def _updates_agree(p0: dict, got: dict, want: dict, lr: float) -> float:
    """The share of parameters whose update (from `p0`) in `got` is within
    lr / 10 of the one in `want`."""
    import torch

    close = total = 0
    for k, w in want.items():
        close += int(torch.count_nonzero(((got[k] - p0[k]) - (w - p0[k])).abs() <= lr / 10))
        total += w.numel()
    return close / total


def _expected_collectives(state, micro: int) -> dict:
    """The collectives of `micro` microbatches of a sharded step: the
    row-parallel sums (2 a block a data row, forward and backward, and the
    recompute under remat), one gradient reduction a tensor a group (a
    model column for a model-sharded tensor, else the grid), gathers and
    reduce-scatters for the FSDP tensors."""
    data, model = state.mesh.shape["data"], state.mesh.shape["model"]
    cfg = state.groups[0].cfg
    passes = 3 if getattr(cfg, "remat", False) else 2
    sums = data * cfg.depth * 2 * passes if model > 1 else 0
    groups = {name: model if "model" in spec else 1 for name, spec in state.specs.items()}
    fsdp = sum(g for name, g in groups.items() if "data" in state.specs[name])
    return {"all_reduce_sum": micro * sums, "all_reduce_max": 0,
            "grad_all_reduce": micro * (sum(groups.values()) - fsdp), "all_gather": micro * fsdp,
            "reduce_scatter": micro * fsdp}


def _sharded_runs(label, card, model, make_step, opt, mesh, batch, draws, steps, tol, per_micro, fsdp=False, k=1,
                  generator=None, reference=None, keep=False):
    """The unsharded step (or `reference`: its losses, step walls, gradient
    and parameters, already run) and the sharded step over `mesh` from the same
    state and draws: the gradient at the start (k == 1), then `steps`
    steps. Checks each sharded step's kernel launches (`per_micro` a
    microbatch) and collectives exactly, and the loss, gradient and updates
    against `tol`. Returns (the reference, the sharded run's record, the
    sharded state when `keep`)."""
    import copy

    import torch

    from f5_tts_tpu_torch.models.shard import shard_train_state
    from f5_tts_tpu_torch.parallel import mesh as M
    from f5_tts_tpu_torch.training import trainer as T

    t_run = time.perf_counter()

    def gen(i):
        return None if generator is None else torch.Generator(device="cuda").manual_seed(generator + i)

    step = make_step(opt, k)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    if reference is None:
        reference = {}
        if k == 1:
            dit = copy.deepcopy(model)
            loss = step.objective.loss(dit, *batch, gen(0), draws)
            reference["grad"] = dict(zip(p0, (g.detach() for g in torch.autograd.grad(loss, list(dit.parameters())))))
            del dit
        dit = copy.deepcopy(model)
        state = T.init_train_state(dit, opt, ema=True)
        reference["losses"], reference["walls_ms"] = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reference["losses"].append(step(state, *batch, gen(i), draws).item())
            reference["walls_ms"].append((time.perf_counter() - t0) * 1e3)
        reference["params"] = {n: p.detach().clone() for n, p in dit.named_parameters()}
        del dit, state
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    state = shard_train_state(T.init_train_state(model, opt, ema=True), mesh, fsdp=fsdp)
    stored = state.nbytes()[0]
    sharded = M.shard_train_step(step, mesh, state, grad_accum=k, fsdp=fsdp)
    record = {"label": label, "stored_slot0": stored}
    launched = dict(ZERO)
    if "grad" in reference:
        before = counts()
        M.reset_collective_counts()
        _, grads = sharded.gradients(state, *batch, gen(0), draws)
        for key, v in counts().items():
            launched[key] += v - before[key]
        if M.collective_counts() != _expected_collectives(state, 1):
            raise AssertionError(f"{label}: collectives {M.collective_counts()}, expected "
                                 f"{_expected_collectives(state, 1)}")
        record["grad_rel_l2"] = _rel_l2(grads, reference["grad"])
        del grads
    losses, walls = [], []
    for i in range(steps):
        before = counts()
        M.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(sharded(state, *batch, gen(i), draws).item())
        walls.append(time.perf_counter() - t0)
        got = {key: v - before[key] for key, v in counts().items()}
        want = {key: k * v for key, v in per_micro.items()}
        if got != want:
            raise AssertionError(f"{label} step {i}: kernel launches {got}, expected {want}")
        if M.collective_counts() != _expected_collectives(state, k):
            raise AssertionError(f"{label} step {i}: collectives {M.collective_counts()}, expected "
                                 f"{_expected_collectives(state, k)}")
        for key, v in got.items():
            launched[key] += v
    record.update(losses=losses, walls_ms=[w * 1e3 for w in walls], unsharded_walls_ms=reference["walls_ms"],
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  collectives_a_step=M.collective_counts(), launches=launched)
    full = M.gather_state(state)["params"]
    record["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(losses, reference["losses"]))
    record["updates_agree"] = _updates_agree(p0, full, reference["params"], MESH_TRAIN_LR)
    record["update_rel_l2"] = _rel_l2({n: full[n] - p0[n] for n in p0},
                                      {n: reference["params"][n] - p0[n] for n in p0})
    print(f"{label}: losses {', '.join(f'{x:.6f}' for x in losses)} against unsharded "
          f"{', '.join(f'{x:.6f}' for x in reference['losses'])} (largest relative difference "
          f"{record['loss_rel']:.3e}, tol {tol['loss']}); gradient relative L2 "
          f"{record.get('grad_rel_l2', float('nan')):.3e} (tol {tol['grad']}); updates within lr/10 of "
          f"unsharded {record['updates_agree']:.6f} (at least {tol['updates']}), the update's relative L2 "
          f"{record['update_rel_l2']:.3e}; step walls {', '.join(f'{w:.1f}' for w in record['walls_ms'])} ms "
          f"against the unsharded steps' {', '.join(f'{w:.1f}' for w in reference['walls_ms'])} ms; "
          f"peak memory {record['peak_gib']:.2f} GiB; slot 0 stores {json.dumps(stored)} bytes; collectives a "
          f"step {json.dumps(record['collectives_a_step'])}; kernel launches {json.dumps(launched)}; the run with its "
          f"unsharded reference {time.perf_counter() - t_run:.1f} s; on {card}")
    if not (record["loss_rel"] <= tol["loss"] and record.get("grad_rel_l2", 0.0) <= tol["grad"]
            and record["updates_agree"] >= tol["updates"]):
        raise AssertionError(f"{label}: the sharded step disagrees with the unsharded step: {record}")
    del full
    if not keep:
        del state
        torch.cuda.empty_cache()
        state = None
    return reference, record, state


def dp_rank_child(rank: int, port: int, out: str) -> None:
    """One rank of phase 10b's two-rank step: the base DiT of the phase
    (the same seed), the grid of one slot on the card that a trainer without
    a mesh takes when several processes run (training/trainer.py
    `training_grid`), the process group over gloo at localhost:`port`; one DP step on this rank's half of the global
    batch with the global draws. Writes the loss and a few parameters."""
    import torch

    from f5_tts_tpu_torch.models.shard import shard_train_state
    from f5_tts_tpu_torch.parallel import distributed as D
    from f5_tts_tpu_torch.parallel import initialize
    from f5_tts_tpu_torch.parallel import mesh as M
    from f5_tts_tpu_torch.training import trainer as T

    device_phase_quiet()
    initialize(coordinator_address=f"localhost:{port}", num_processes=2, process_id=rank, backend="gloo")
    model, (mel, text, lens), draws = _mesh_train_inputs()
    opt = T.make_optimizer(MESH_TRAIN_LR, 1e-2, 0, 1000)
    mesh = T.training_grid(None, torch.device("cuda:0"))  # a trainer's grid without a mesh, with two processes
    state = shard_train_state(T.init_train_state(model.dit, opt, ema=True), mesh)
    step = M.shard_train_step(T.make_train_step(model.cfm_cfg, opt, ema_decay=0.999), mesh, state)
    half = slice(rank * TRAIN_BATCH // 2, (rank + 1) * TRAIN_BATCH // 2)
    reset_counts()
    t0 = time.perf_counter()
    loss = step(state, mel[half], text[half], lens[half], draws=draws).item()
    wall = time.perf_counter() - t0
    full = M.gather_state(state)["params"]
    torch.save({k: full[k].cpu() for k in TWO_RANK_WATCHED}, f"{out}/rank{rank}.pt")
    print(json.dumps({"rank": D.process_index(), "world": D.process_count(), "loss": loss, "step_s": wall,
                      "launches": counts()}), flush=True)
    torch.distributed.destroy_process_group()


TWO_RANK_WATCHED = ("proj_out.weight", "transformer_blocks.0.attn.to_q.weight", "time_embed.time_mlp.0.weight")


def device_phase_quiet() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mesh_train_inputs(cfg=None, seed=11):
    """Phase 10b's model (the base DiT in bf16 unless `cfg`), batch (4 x
    1024 frames) and fixed global draws, from `seed` on the card."""
    import torch

    from f5_tts_tpu_torch import F5TTS, CFMConfig
    from f5_tts_tpu_torch.config import F5TTS_V1_BASE
    from f5_tts_tpu_torch.models.cfm import draw_cfm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = F5TTS.init(gen, cfg or F5TTS_V1_BASE.replace(compute_dtype="bfloat16"), device="cuda",
                       cfm_cfg=CFMConfig())
    batch = _train_batch(gen)
    return model, batch, draw_cfm(gen, model.cfm_cfg, TRAIN_BATCH, TRAIN_FRAMES, 100, torch.device("cuda"))


def mesh_training_phase(card: str, tmp_base: str | None) -> dict:
    """Training over a 2 x 2 grid of the card (parallel/mesh.py): K1 with
    its lse and K2 (bf16), K1-f32 and K2-f32 at the slot shapes against
    their plain versions; the base DiT (bf16) sharded against unsharded
    (DP x TP 2 steps, grad_accum=2 1 step, FSDP 2 steps: loss, gradient,
    updates, exact launches and collectives, stored bytes and peak memory);
    the float32 witness at reduced depth (dropout and remat on) at 2e-5; a
    sharded trainer's checkpoint loaded by an unsharded trainer that
    continues; the checkpoint manager's asynchronous sharded save, latest
    and restores (another layout; EMA adapted); DURATION_V2 on 2 x 2 at
    2e-5; two ranks over gloo on the card against the one-process data-2
    step. Returns the kernels' launches of the sharded runs."""
    import copy

    import torch

    from f5_tts_tpu_torch import F5TTS
    from f5_tts_tpu_torch.config import DURATION_V2, F5TTS_V1_BASE
    from f5_tts_tpu_torch.models.duration import DurationPredictor
    from f5_tts_tpu_torch.models.shard import shard_train_state
    from f5_tts_tpu_torch.ops import flash_attention as fa
    from f5_tts_tpu_torch.parallel import mesh as M
    from f5_tts_tpu_torch.training import checkpoints as C
    from f5_tts_tpu_torch.training import trainer as T
    from f5_tts_tpu_torch.training.duration_trainer import make_duration_train_step

    t_phase = time.perf_counter()
    phase(f"mesh training: a {MESH_TRAIN['data']} x {MESH_TRAIN['model']} grid (data x model) of the card: the "
          "base DiT (bf16) DP x TP, grad_accum=2 and FSDP against unsharded; the float32 witness; checkpoints; "
          "DURATION_V2; two ranks over gloo")
    devices = ["cuda:0"] * (MESH_TRAIN["data"] * MESH_TRAIN["model"])
    if torch.cuda.device_count() >= len(devices):
        devices = [f"cuda:{i}" for i in range(len(devices))]
    mesh = M.create_mesh(**MESH_TRAIN, devices=devices)
    print(f"grid: {mesh}")
    slots = MESH_TRAIN["data"] * MESH_TRAIN["model"]
    total = dict(ZERO)

    def add(launched):
        for key, v in launched.items():
            total[key] += v

    # the slot shapes: a data row's 2 rows of 1024 frames; the slot's heads of 64 on its projections
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = [list(r) for r in (TRAIN_LENS[:2], TRAIN_LENS[2:])]
    cfg = F5TTS_V1_BASE
    slot_ms = {}
    for name, dtype, h, masks in (("bf16", torch.bfloat16, cfg.heads // MESH_TRAIN["model"], [None] + rows),
                                  ("f32", torch.float32, DURATION_V2.heads // MESH_TRAIN["model"], [None, rows[1]])):
        for lens in masks:
            c = _attention_grad_case(gen, f"mesh training slot ({name})", dtype, 2, h, TRAIN_FRAMES, 64, lens)
        q, k, v, g, out, lse = c["q"], c["k"], c["v"], c["g"], c["out"], c["lse"]
        key_mask, cos, sin, scale = c["key_mask"], c["cos"], c["sin"], c["scale"]
        fwd = device_ms(lambda: fa._forward_kernel(q, k, v, scale, key_mask, cos, sin, with_lse=True))
        bwd = device_ms(lambda: fa._backward_kernel(q, k, v, out, lse, g, scale, key_mask, cos, sin))
        slot_ms[name] = (fwd, bwd)
        print(f"slot shape {name} [2, {h}, {TRAIN_FRAMES}, 64]: K1 with lse {fwd:.4f} ms, K2 {bwd:.4f} ms of device "
              f"time; on {card}")

    # the base DiT in bf16
    model, batch, draws = _mesh_train_inputs()
    opt = T.make_optimizer(MESH_TRAIN_LR, 1e-2, 0, 1000)
    bcfg, cfm_cfg = model.dit_cfg, model.cfm_cfg

    def cfm_step(o, k):
        return T.make_train_step(cfm_cfg, o, ema_decay=0.999, grad_accum=k)

    per_micro = {**ZERO, "flash_attention_fwd": bcfg.depth * slots, "flash_attention_bwd": bcfg.depth * slots}
    ref, dp, _ = _sharded_runs("base DiT, DP x TP", card, model.dit, cfm_step, opt, mesh, batch, draws, 2,
                               MESH_TRAIN_TOL, per_micro)
    add(dp["launches"])
    _, fsdp, _ = _sharded_runs("base DiT, FSDP", card, model.dit, cfm_step, opt, mesh, batch, draws, 2,
                               MESH_TRAIN_TOL, per_micro, fsdp=True, reference=ref)
    add(fsdp["launches"])
    del ref
    micro = T.split_microbatches(2, *batch, data_size=MESH_TRAIN["data"])
    half = TRAIN_BATCH // 2
    draws2 = [draws.rows(slice(0, half)), draws.rows(slice(half, TRAIN_BATCH))]
    _, accum, _ = _sharded_runs("base DiT, grad_accum=2", card, model.dit, cfm_step, opt, mesh, micro, draws2, 1,
                                MESH_TRAIN_TOL, per_micro, k=2)
    add(accum["launches"])
    ratio = {part: fsdp["stored_slot0"][part] / dp["stored_slot0"][part] for part in dp["stored_slot0"]}
    print(f"FSDP: slot 0 stores {json.dumps(fsdp['stored_slot0'])} bytes against {json.dumps(dp['stored_slot0'])} "
          f"without ({', '.join(f'{k} {v:.3f}' for k, v in ratio.items())} of it); peak memory "
          f"{fsdp['peak_gib']:.2f} against {dp['peak_gib']:.2f} GiB; on {card}")
    del model, batch
    torch.cuda.empty_cache()

    # the float32 witness: full width, reduced depth, dropout and remat on
    wcfg = F5TTS_V1_BASE.replace(compute_dtype="float32", depth=WITNESS_DEPTH, dropout=0.1, remat=True)
    wmodel, wbatch, wdraws = _mesh_train_inputs(wcfg, seed=13)
    wper = {**ZERO, "flash_attention_fwd_f32": 2 * wcfg.depth * slots, "flash_attention_bwd_f32": wcfg.depth * slots}
    wref, wdp, wstate = _sharded_runs("float32 witness, DP x TP", card, wmodel.dit, cfm_step, opt, mesh, wbatch,
                                      wdraws, 2, WITNESS_TOL, wper, generator=100, keep=True)
    add(wdp["launches"])
    _, wfsdp, _ = _sharded_runs("float32 witness, FSDP", card, wmodel.dit, cfm_step, opt, mesh, wbatch, wdraws, 2,
                                WITNESS_TOL, wper, fsdp=True, generator=100, reference=wref)
    add(wfsdp["launches"])

    with tempfile.TemporaryDirectory(dir=tmp_base) as tmp:
        # a sharded trainer's files, loaded by an unsharded trainer that continues
        t0 = time.perf_counter()
        sharded = T.F5TTSTrainer(wmodel, results_dir=tmp, ema_decay=0.999, mesh=mesh)
        sharded.state = wstate
        sharded.save_checkpoint(2)
        t1 = time.perf_counter()
        fresh = T.F5TTSTrainer(F5TTS.init(torch.Generator(device="cuda").manual_seed(14), wcfg, device="cuda"),
                               results_dir=tmp, ema_decay=0.999)
        fresh.state = T.init_train_state(fresh.model.dit, opt, ema=True)
        fresh.load_checkpoint(2)
        t2 = time.perf_counter()
        full = M.gather_state(wstate)
        loaded = dict(fresh.model.dit.named_parameters())
        for name in loaded:
            if not (torch.equal(loaded[name], full["params"][name]) and torch.equal(fresh.state.ema[name],
                                                                                   full["ema"][name])
                    and torch.equal(fresh.state.opt_state["mu"][name], full["mu"][name])
                    and torch.equal(fresh.state.opt_state["nu"][name], full["nu"][name])):
                raise AssertionError(f"the sharded trainer's checkpoint did not load as it was: {name}")
        if (fresh.state.step, fresh.state.opt_state["count"]) != (2, 2):
            raise AssertionError(f"the loaded checkpoint's step: {fresh.state.step}")
        p0 = {n: p.detach().clone() for n, p in loaded.items()}
        step = cfm_step(opt, 1)
        cont_u = step(fresh.state, *wbatch, torch.Generator(device="cuda").manual_seed(102), wdraws).item()
        cont_s = M.shard_train_step(step, mesh, wstate)(wstate, *wbatch, torch.Generator(device="cuda").manual_seed(102),
                                                         wdraws).item()
        agree = _updates_agree(p0, M.gather_state(wstate)["params"],
                               {n: p.detach() for n, p in fresh.model.dit.named_parameters()}, MESH_TRAIN_LR)
        print(f"checkpoint round trip (float32 witness): the 2 x 2 trainer saved in {t1 - t0:.1f} s, an unsharded "
              f"trainer loaded in {t2 - t1:.1f} s: weights, EMA, moments and step identical; the next step "
              f"unsharded {cont_u:.6f} and sharded {cont_s:.6f} (relative {abs(cont_u - cont_s) / abs(cont_u):.3e}, "
              f"tol {WITNESS_TOL['loss']}), updates agreeing {agree:.6f}; files "
              + ", ".join(f"{f.name} {f.stat().st_size / 2**20:.0f} MiB" for f in sorted(Path(tmp).glob("*"))))
        if not (abs(cont_u - cont_s) <= WITNESS_TOL["loss"] * abs(cont_u) and agree >= WITNESS_TOL["updates"]):
            raise AssertionError("the unsharded trainer did not continue as the sharded one")
        del fresh, loaded, p0

        # the checkpoint manager: asynchronous sharded save, latest, restores over FSDP and unsharded without EMA
        mgr = C.TrainCheckpointManager(Path(tmp) / "manager")
        t0 = time.perf_counter()
        mgr.save(3, wstate)
        t1 = time.perf_counter()
        mgr.wait()
        t2 = time.perf_counter()
        if mgr.latest_step() != 3 or mgr.all_steps() != [3]:
            raise AssertionError(f"checkpoint manager: latest {mgr.latest_step()}, steps {mgr.all_steps()}")
        saved = M.gather_state(wstate)
        target = shard_train_state(T.init_train_state(copy.deepcopy(wmodel.dit), opt, ema=True), mesh, fsdp=True)
        t3 = time.perf_counter()
        mgr.restore(3, target)
        t4 = time.perf_counter()
        back = M.gather_state(target)
        for kind in ("params", "mu", "nu", "ema"):
            for name, t in saved[kind].items():
                if not torch.equal(back[kind][name], t):
                    raise AssertionError(f"checkpoint manager: {kind} {name} changed over FSDP")
        del target, back
        plain = T.init_train_state(copy.deepcopy(wmodel.dit), opt, ema=False)
        C.restore_orbax_adapting_ema(mgr, 3, plain)
        for name, p in plain.model.named_parameters():
            if not torch.equal(p, saved["params"][name]):
                raise AssertionError(f"checkpoint manager: {name} changed when restored without EMA")
        mgr.close()
        size = sum(f.stat().st_size for f in (Path(tmp) / "manager").rglob("*") if f.is_file())
        print(f"checkpoint manager (float32 witness, 2 x 2 sharded, written without gathering): save returned in "
              f"{t1 - t0:.2f} s, committed {t2 - t1:.2f} s later ({size / 2**20:.0f} MiB); latest {mgr.latest_step()}; "
              f"restored over 2 x 2 FSDP in {t4 - t3:.2f} s, and unsharded without EMA (dropped), both identical")
        del plain, saved
    del wstate, wmodel, wref, sharded
    torch.cuda.empty_cache()

    # DURATION_V2 in float32
    gen = torch.Generator(device="cuda").manual_seed(15)
    predictor = DurationPredictor.init(gen, DURATION_V2, device="cuda")
    dbatch = _train_batch(gen)
    rand_frac = torch.rand(TRAIN_BATCH, generator=gen, device="cuda")
    fps = predictor.audio_cfg.frames_per_second
    dper = {**ZERO, "flash_attention_fwd_f32": DURATION_V2.depth * slots,
            "flash_attention_bwd_f32": DURATION_V2.depth * slots}
    _, dur, _ = _sharded_runs("DURATION_V2, DP x TP", card, predictor,
                              lambda o, k: make_duration_train_step(o, fps, ema_decay=0.999, grad_accum=k), opt, mesh,
                              dbatch, rand_frac, 1, WITNESS_TOL, dper)
    add(dur["launches"])
    del predictor
    torch.cuda.empty_cache()

    # two ranks over gloo on the one card against the one-process data-2 step
    with tempfile.TemporaryDirectory(dir=tmp_base) as tmp:
        import socket

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        procs = [_started([f"import chip_smoke as s; s.dp_rank_child({rank}, {port}, {tmp!r})"], f"{tmp}/rank{rank}")
                 for rank in range(2)]
        model, batch, draws = _mesh_train_inputs()
        step = T.make_train_step(model.cfm_cfg, opt, ema_decay=0.999)
        one = M.create_mesh(data=2, devices=["cuda:0"] * 2)
        state = shard_train_state(T.init_train_state(model.dit, opt, ema=True), one)
        want_loss = M.shard_train_step(step, one, state)(state, *batch, draws=draws).item()
        want = M.gather_state(state)["params"]
        del model, state
        ranks = [json.loads(_finished(p, f"{tmp}/rank{r}", f"rank {r}", timeout=300).strip().splitlines()[-1])
                 for r, p in enumerate(procs)]
        wall = time.perf_counter() - t0
        diffs = []
        for r in range(2):
            got = torch.load(f"{tmp}/rank{r}.pt")
            diffs.append(max((got[k] - want[k].cpu()).abs().max().item() for k in TWO_RANK_WATCHED))
        print(f"two ranks over gloo on {card}: losses {ranks[0]['loss']:.8f}, {ranks[1]['loss']:.8f} (world "
              f"{ranks[0]['world']}), the one-process data-2 step {want_loss:.8f}; watched parameters' largest "
              f"difference {max(diffs):.3e}; each rank's step {ranks[0]['step_s']:.2f}, {ranks[1]['step_s']:.2f} s "
              f"(its first, with gloo's copies through the host), both ranks {wall:.1f} s with start-up")
        if not (ranks[0]["loss"] == ranks[1]["loss"] and abs(ranks[0]["loss"] - want_loss) <= 1e-6 * abs(want_loss)
                and max(diffs) <= MESH_TRAIN_LR / 10):
            raise AssertionError(f"the two ranks disagree with each other or the one-process step: {ranks}, "
                                 f"{want_loss}, {diffs}")
        del want
    torch.cuda.empty_cache()
    print(f"mesh training phase: {time.perf_counter() - t_phase:.1f} s; launches of its sharded runs "
          f"{json.dumps(total)}; slot kernels' device ms {json.dumps(slot_ms)}; on {card}")
    return total


PROBE_ATTN = ("attn_pack2", "attn_flat", "flash_nhd", "flash_bhnd_rope")


def reset_probe_counts():
    from f5_tts_tpu_torch.ops import attn_variants
    from f5_tts_tpu_torch.ops.ln_modulate import ln_modulate

    for name in PROBE_ATTN:
        getattr(attn_variants, name).launches = 0
    ln_modulate.launches = 0


def probe_counts() -> dict:
    from f5_tts_tpu_torch.ops import attn_variants
    from f5_tts_tpu_torch.ops.ln_modulate import ln_modulate

    return {**{name: getattr(attn_variants, name).launches for name in PROBE_ATTN},
            "ln_modulate": ln_modulate.launches}


def probe_kernel_phase():
    import torch

    from f5_tts_tpu_torch.ops import attn_variants as av
    from f5_tts_tpu_torch.ops.ln_modulate import ln_modulate, ln_modulate_plain
    from f5_tts_tpu_torch.tools.fusion_probe import perm_matrix, rope_tables

    phase("probe kernels vs plain: attention variants (bf16, CUDA) and LayerNorm + modulate (Triton)")
    gen = torch.Generator(device="cuda").manual_seed(7)
    plain = {"attn_pack2": av.attention_plain, "attn_flat": av.attention_plain,
             "flash_nhd": av.flash_nhd_plain, "flash_bhnd_rope": av.flash_bhnd_rope_plain}
    results = {}
    # (label, kernel, b, h, n, d): the probe tools' shape, and each kernel (all on the TMA + wgmma core) at a ragged n
    cases = [(name, name, 2, 16, 1024, 64) for name in PROBE_ATTN]
    cases += [(f"{name}, ragged n", name, 2, 16, 1000, 64) for name in PROBE_ATTN]
    for label, name, b, h, n, d in cases:
        nhd = name == "flash_nhd"
        q, k, v = (torch.randn(*((b, n, h, d) if nhd else (b, h, n, d)), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        rope = ()
        if name.startswith("flash"):
            rope = (*rope_tables(n, d, "cuda"), torch.tensor(perm_matrix(d), device="cuda"))
        scale = d ** -0.5
        fn = getattr(av, name)
        out = fn(q, k, v, *rope, scale)
        ref = plain[name](q, k, v, *rope, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ms = _time_ms(lambda: fn(q, k, v, *rope, scale))
        plain_ms = _time_ms(lambda: plain[name](q, k, v, *rope, scale))
        flop = 4 * b * h * n * n * d + (4 * b * h * n * d * d if rope else 0)  # + x @ P for q and k
        print(f"{label}: [b={b}, h={h}, n={n}, d={d}] {'[b, n, h, d]' if nhd else '[b, h, n, d]'} "
              f"rope={bool(rope)}: max|kernel - plain| = {err:.3e} (tol {ATTN_TOL}); kernel {ms:.4f} ms "
              f"({flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
        if not (err <= ATTN_TOL):
            raise AssertionError(f"{name} disagrees with its plain version at {label}: {err}")
        # yardstick: SDPA on [b, h, n, d] views, q and k already rotated for the RoPE variants
        qh, kh, vh = (t.transpose(1, 2) if nhd else t for t in (q, k, v))
        if rope:
            qh, kh = av.rope_plain(qh, *rope), av.rope_plain(kh, *rope)
        library_ms = _time_ms(lambda: _sdpa(qh, kh, vh, scale))
        bound_ms, bound_by = bound(flop, nbytes(q, k, v, out, *rope), "bf16")
        _library_line(label, "SDPA, RoPE outside" if rope else "SDPA", library_ms, bound_ms, bound_by)
        results[label] = {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
        if rope:  # the pre-pass takes q and k unrotated, as [b, h, n, d] views of the call's layout
            views = [t.transpose(1, 2) if nhd else t for t in (q, k)]
            _device_times(label, av, fn, (q, k, v, *rope, scale), (*views, rope))
        else:
            _device_times(label, av, fn, (q, k, v, scale))

    for label, (b, n, d) in (("ln_modulate", (2, 1024, 1024)), ("ln_modulate, ragged n", (2, 1000, 1024))):
        x, scale, shift = (torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                           for shape in ((b, n, d), (b, d), (b, d)))
        out = ln_modulate(x, scale, shift)
        ref = ln_modulate_plain(x, scale, shift)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        within = bool((diff <= LN_TOL[0] + LN_TOL[1] * ref.float().abs()).all())
        ms = _time_ms(lambda: ln_modulate(x, scale, shift))
        plain_ms = _time_ms(lambda: ln_modulate_plain(x, scale, shift))
        # about 7 float32 operations an element: mean, centring, square and sum, normalise, modulate
        bound_ms, bound_by = bound(7 * b * n * d, nbytes(x, scale, shift, out), "f32")
        print(f"{label}: [b={b}, n={n}, d={d}] bf16: max|kernel - plain| = {err:.3e} "
              f"(tol {LN_TOL[0]} + {LN_TOL[1]} |plain|: {'met' if within else 'NOT met'}); kernel {ms:.4f} ms "
              f"({nbytes(x, out) / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms")
        _library_line(label, "", None, bound_ms, bound_by)
        if not within:
            raise AssertionError(f"ln_modulate disagrees with its plain version at {label}: {err}")
        _device_times(label, None, ln_modulate, (x, scale, shift))
        results[label] = {"err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                          "bound_ms": bound_ms, "bound_by": bound_by}
    core_hashes()
    return results


def core_hashes() -> dict:
    """SHA-256 of P1's, P3's and P4's outputs at fixed inputs made with numpy
    from a seed (d 64 and 128, a ragged n), printed and returned: the same
    bits in two checkouts show that a change left their arithmetic as it was."""
    import hashlib

    import numpy as np
    import torch

    from f5_tts_tpu_torch.ops import attn_variants as av
    from f5_tts_tpu_torch.tools.fusion_probe import perm_matrix, rope_tables

    hashes = {}
    for name in ("attn_pack2", "flash_nhd", "flash_bhnd_rope"):
        for b, h, n, d in ((2, 16, 1024, 64), (2, 4, 1000, 128)):
            rng = np.random.default_rng(n + d)
            shape = (b, n, h, d) if name == "flash_nhd" else (b, h, n, d)
            q, k, v = (torch.tensor(rng.standard_normal(shape, dtype=np.float32), device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            rope = () if name == "attn_pack2" else (*rope_tables(n, d, "cuda"), torch.tensor(perm_matrix(d), device="cuda"))
            out = getattr(av, name)(q, k, v, *rope, d ** -0.5)
            hashes[f"{name} [{b}, {h}, {n}, {d}]"] = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    print("output hashes: " + json.dumps(hashes))
    return hashes


def _device_times(label, av, fn, args, prepass=None) -> None:
    """A probe kernel's device time (`device_ms`), for a RoPE attention
    kernel its pre-pass's alone (`prepass`: the unrotated [b, h, n, d] views
    of q and k and the rope inputs; `av` is the attention variants' module,
    where the checkout has a pre-pass), and the host's time per wrapper
    call."""
    import statistics

    dev = device_ms(lambda: fn(*args))
    pre = ""
    if prepass is not None:
        qh, kh, rope = prepass
        pre = ", pre-pass alone none in this checkout"
        if hasattr(av, "rope_prepass"):
            n_pad = -(-qh.shape[2] // av.ROPE_ROW_PAD) * av.ROPE_ROW_PAD
            pre = f", pre-pass alone {device_ms(lambda: av.rope_prepass(qh, kh, *rope, n_pad)):.4f} ms"
    us = host_us(lambda: fn(*args))
    print(f"{label}: device {dev:.4f} ms{pre}; host per call (100 calls enqueued behind a spin "
          f"kernel, 10 runs) median {statistics.median(us):.1f} us, least {us[0]:.1f}, most {us[-1]:.1f}")


def probe_tools_phase(card: str):
    """Both probe tools' entry points at their full shapes, with each probe
    kernel's launches counted over the run."""
    import torch

    from f5_tts_tpu_torch.tools import attn_variants, fusion_probe

    phase(f"probe tools: attn_variants (reps {PROBE_REPS['attn_variants']}) and fusion_probe all "
          f"(reps {PROBE_REPS['fusion_probe']})")
    reset_probe_counts()
    t0 = time.perf_counter()
    variants = attn_variants.main(reps=PROBE_REPS["attn_variants"])
    probes = fusion_probe.main("all", reps=PROBE_REPS["fusion_probe"])
    torch.cuda.synchronize()
    launched = probe_counts()
    print(f"probe tools: {time.perf_counter() - t0:.1f} s; probe kernel launches {launched}; on {card}")
    for name, n in launched.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the probe tools")
    for name, (_, err) in variants.items():
        if not err <= ATTN_TOL:
            raise AssertionError(f"attention variant {name} disagrees with the unfused version: {err}")
    checks = ((probes["attn"]["rope-as-matmul maxerr"], F32_TOL, "rope as a product"),
              (probes["layer"]["layer ropek maxerr vs current"], ATTN_TOL, "attention layer through P4"),
              (probes["layer"]["layer nhd maxerr vs current"], ATTN_TOL, "attention layer through P3"))
    for err, tol, what in checks:
        if not err <= tol:
            raise AssertionError(f"{what} disagrees with the reference in the probe tools: {err} (tol {tol})")
    return launched


PROFILE_NAME_CHARS = 80
# torch.profiler kernel groups, by a substring of the kernel's name; the first match wins
PROFILE_GROUPS = (
    ("attention pre-pass (float32)", ("tc_prep",)),
    ("K2 attention backward", ("flash_bwd",)),
    ("K1 pre-pass (bf16)", ("flash_fwd_prepass",)),
    ("K1 attention forward", ("flash_fwd", "attn_core")),
    ("K3 dequantizing matmul", ("qmm_",)),
    ("W8A8 quantize_rows (Triton)", ("quantize_rows",)),
    ("W8A8 rescale_bias (Triton)", ("rescale_bias",)),
    ("W8A8 int8 GEMM (torch._int_mm)", ("gemm_s8", "imma")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "splitkreduce")),
    ("conv (cuDNN)", ("conv", "cudnn", "winograd", "implicit")),
    ("FFT", ("fft",)),
    ("reductions", ("reduce", "softmax", "norm")),
    ("dtype casts and copies", ("copy", "cast", "convert")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index", "cat", "where", "fill")),
)


def _profiled(label: str, fn) -> None:
    """Run `fn` once under torch.profiler and print its wall time, the
    device's busy time (the sum of kernel times), its peak memory, the
    kernel time and launches by group, and the largest kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict[str, list] = {}
    kernels: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.device_time_total <= 0:
            continue
        low = ev.name.lower()
        group = next((g for g, keys in PROFILE_GROUPS if any(key in low for key in keys)), "other")
        entry = groups.setdefault(group, [0.0, 0])
        entry[0] += ev.device_time_total / 1e3
        entry[1] += 1
        name = ev.name[:PROFILE_NAME_CHARS]  # templated names differ far out; group by their start
        kernels[name] = kernels.get(name, 0.0) + ev.device_time_total / 1e3
    busy = sum(ms for ms, _ in groups.values())
    print(f"profile, {label}: wall {wall * 1e3:.1f} ms under the profiler, device busy {busy:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; by group (ms, launches): "
          + "; ".join(f"{g} {ms:.2f} ({n})" for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    print(f"profile, {label}: largest kernels (ms): "
          + "; ".join(f"{name} {ms:.2f}" for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]))
    if busy <= 0:
        raise AssertionError(f"the profile of the {label} shows no device time")


def dit_f32_launches_by_shape(cfg) -> dict:
    """The quantized-linear launches of one float32 DiT forward on
    `_dit_out`'s input (2 x 128 frames, one flow time), by (m, k, n): the
    time conditioning at m = 1 (the time MLP from its 256 frequencies, one
    AdaLN linear per block, norm_out), the text branch and the blocks at 256
    rows."""
    d, depth, conv, rows = cfg.dim, cfg.depth, cfg.conv_layers, 2 * 128
    wide_text = cfg.text_dim * cfg.conv_mult
    return {(1, 256, d): 1, (1, d, d): 1, (1, d, 6 * d): depth, (1, d, 2 * d): 1,
            (rows, cfg.text_dim, wide_text): conv, (rows, wide_text, cfg.text_dim): conv,
            (rows, d, d): 4 * depth, (rows, d, cfg.ff_mult * d): depth, (rows, cfg.ff_mult * d, d): depth,
            (rows, d, cfg.mel_dim): 1}


def ranking_phase(card: str, snap: str) -> None:
    """K3's device time per int4 request, K1's per request and per CFM step,
    K2's per CFM step and K1-f32's and
    K2-f32's per duration step beside their library calls' (device times,
    the host left out), the host time of one wrapper call, and a
    torch.profiler breakdown of one int4 request, one CFM step and one
    duration step. It calls only entry points whose interface the kernel
    redesigns kept, so a copy of this file in a checkout from before them
    measures that checkout the same way."""
    import statistics

    import numpy as np
    import torch
    import torch.nn.functional as F

    from f5_tts_tpu_torch import F5TTS, CFMConfig
    from f5_tts_tpu_torch.config import DURATION_V2, F5TTS_V1_BASE
    from f5_tts_tpu_torch.models.cfm import draw_cfm
    from f5_tts_tpu_torch.models.duration import DurationPredictor
    from f5_tts_tpu_torch.models.quant import quantize_kernel
    from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb, rotary_freqs
    from f5_tts_tpu_torch.ops import flash_attention as fa
    from f5_tts_tpu_torch.ops.qmatmul import dequantize_kernel, qmatmul
    from f5_tts_tpu_torch.training import trainer as T
    from f5_tts_tpu_torch.training.duration_trainer import make_duration_train_step

    phase("ranking: device time per request and step against the library calls; host time per call; profiles")
    cfg = F5TTS_V1_BASE
    if cfg.depth * EVALS_PER_REQUEST != 682:
        raise AssertionError(f"K1 calls a request: {cfg.depth * EVALS_PER_REQUEST}, expected 682")
    per_shape = qmm_launches_by_shape(cfg)
    if sum(per_shape.values()) != qmm_launches_per_request(cfg):
        raise AssertionError(f"launches by shape {per_shape} do not sum to {qmm_launches_per_request(cfg)}")
    rng = np.random.default_rng(0)
    k3_ms = k3_lib = 0.0
    host = {}
    for name, m, k, n in QMM_SHAPES:
        # int4 codes with bf16 scales and biases, as a bf16 model holds them; no linear bias
        p = quantize_kernel((rng.uniform(-1, 1, (k, n)) / np.sqrt(k)).astype(np.float32), 4)
        q, s, b = (torch.from_numpy(np.ascontiguousarray(p[t].T)).cuda() for t in ("q", "scales", "biases"))
        s, b = s.to(torch.bfloat16), b.to(torch.bfloat16)
        x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32), device="cuda").to(torch.bfloat16)
        w = dequantize_kernel(q, s, b).to(torch.bfloat16)
        ms, lib = device_ms(lambda: qmatmul(x, q, s, b)), device_ms(lambda: F.linear(x, w))
        k3_ms, k3_lib = k3_ms + per_shape[name] * ms, k3_lib + per_shape[name] * lib
        print(f"K3 int4 bf16 {name} [m={m}, k={k}, n={n}]: device {ms:.4f} ms, F.linear on the dequantized "
              f"weight {lib:.4f} ms; {per_shape[name]} launches per int4 request")
        if (m, k, n) in ((2048, 1024, 1024), (31, 1024, 6144)):
            host[f"K3 [{m}, {k}, {n}]"] = host_us(lambda: qmatmul(x, q, s, b))
    print(f"K3 int4 bf16, per int4 request ({sum(per_shape.values())} launches over the {len(QMM_SHAPES)} "
          f"shapes): kernel {k3_ms:.3f} ms, F.linear on the dequantized weights {k3_lib:.3f} ms, "
          f"lost {k3_ms - k3_lib:.3f} ms; on {card}")

    # K3-f32 over one float32 forward of the int4 DiT (`_dit_f32_check`): int4 codes with float32 scales and
    # biases, as the float32 DiT holds them, and the linears' biases
    by_shape = dit_f32_launches_by_shape(cfg)
    k3f_ms = k3f_lib = 0.0
    for (m, k, n), calls in by_shape.items():
        p = quantize_kernel((rng.uniform(-1, 1, (k, n)) / np.sqrt(k)).astype(np.float32), 4)
        q, s, b = (torch.from_numpy(np.ascontiguousarray(p[t].T)).cuda() for t in ("q", "scales", "biases"))
        x = torch.tensor(rng.standard_normal((m, k)).astype(np.float32), device="cuda")
        bias = torch.tensor(rng.standard_normal(n).astype(np.float32) * 0.1, device="cuda")
        w = dequantize_kernel(q, s, b)
        ms, lib = device_ms(lambda: qmatmul(x, q, s, b, bias)), device_ms(lambda: F.linear(x, w, bias))
        k3f_ms, k3f_lib = k3f_ms + calls * ms, k3f_lib + calls * lib
        print(f"K3-f32 int4 float32 [m={m}, k={k}, n={n}]: device {ms:.4f} ms, F.linear float32 on the dequantized "
              f"weight {lib:.4f} ms; {calls} launches per forward")
    print(f"K3-f32 int4 float32, per float32 forward of the int4 DiT ({sum(by_shape.values())} launches over "
          f"{len(by_shape)} shapes): kernel {k3f_ms:.3f} ms, F.linear float32 on the dequantized weights "
          f"{k3f_lib:.3f} ms, lost {k3f_ms - k3f_lib:.3f} ms; on {card}")

    # K1 at the request's shape ([2, 16, 1024, 64], mask 937, no lse) and at the CFM step's ([4, 16, 1024, 64],
    # no mask, with the lse): q, k, v as [b, n, h*d] projection views, RoPE; SDPA on q and k rotated beforehand
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_calls = {"request": cfg.depth * EVALS_PER_REQUEST, "CFM step": cfg.depth}
    for label, b, valid, with_lse in (("request", 2, 937, False), ("CFM step", TRAIN_BATCH, None, True)):
        h, n, d = cfg.heads, 1024, cfg.dim_head
        q, k, v = (torch.randn(b, n, h * d, generator=gen, device="cuda", dtype=torch.bfloat16)
                   .view(b, n, h, d).transpose(1, 2) for _ in range(3))
        mask = None if valid is None else (torch.arange(n, device="cuda") < valid)[None, :].expand(b, n).contiguous()
        raw = rotary_freqs(n, d, device="cuda")
        rope = (torch.cos(raw), torch.sin(raw))
        key_mask, cos, sin = fa._checked(q, k, v, mask, rope)
        ms = device_ms(lambda: fa._forward_kernel(q, k, v, d ** -0.5, key_mask, cos, sin, with_lse=with_lse))
        qr, kr = apply_rotary_pos_emb(q, rope), apply_rotary_pos_emb(k, rope)
        lib = device_ms(lambda: _sdpa(qr, kr, v, d ** -0.5, mask))
        calls = k1_calls[label]
        print(f"K1 bf16 [{b}, {h}, {n}, {d}] mask={valid} lse={with_lse}: device {ms:.4f} ms, SDPA (RoPE outside) "
              f"{lib:.4f} ms; per {label} ({calls} calls): kernel {calls * ms:.3f} ms, SDPA {calls * lib:.3f} ms, "
              f"lost {calls * (ms - lib):.3f} ms; on {card}")
        if label == "request":
            with torch.no_grad():
                host[f"K1 [{b}, {h}, {n}, {d}] mask {valid}"] = host_us(
                    lambda: fa.flash_attention(q, k, v, d ** -0.5, key_mask=mask, rope=rope))

    # K2 at the CFM training shape: q, k, v and g as [b, n, h*d] projection views, RoPE, no mask
    b, h, n, d = TRAIN_BATCH, 16, TRAIN_FRAMES, 64
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, g = (torch.randn(b, n, h * d, generator=gen, device="cuda").to(torch.bfloat16)
                  .view(b, n, h, d).transpose(1, 2) for _ in range(4))
    raw = rotary_freqs(n, d, device="cuda")
    rope = (torch.cos(raw), torch.sin(raw))
    key_mask, cos, sin = fa._checked(q, k, v, None, rope)
    out, lse = fa._forward_kernel(q, k, v, d ** -0.5, key_mask, cos, sin, with_lse=True)
    args = (q, k, v, out, lse, g, d ** -0.5, key_mask, cos, sin)
    ms = device_ms(lambda: fa._backward_kernel(*args))
    leaves = [t.detach().requires_grad_() for t in (apply_rotary_pos_emb(q, rope), apply_rotary_pos_emb(k, rope), v)]
    sdpa_out = _sdpa(*leaves, d ** -0.5)
    lib = device_ms(lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True), iters=5)
    print(f"K2 bf16 [{b}, {h}, {n}, {d}]: device {ms:.4f} ms, SDPA backward {lib:.4f} ms; per CFM step "
          f"({cfg.depth} calls): kernel {cfg.depth * ms:.3f} ms, SDPA backward {cfg.depth * lib:.3f} ms, "
          f"lost {cfg.depth * (ms - lib):.3f} ms; on {card}")
    host[f"K2 [{b}, {h}, {n}, {d}]"] = host_us(lambda: fa._backward_kernel(*args))

    # K1-f32 and K2-f32 at the duration training shape (float32, [b, n, h*d] views, RoPE, no mask):
    # one forward with the lse and one backward per block of a duration step
    dcfg = DURATION_V2
    b, h, n, d = TRAIN_BATCH, dcfg.heads, TRAIN_FRAMES, dcfg.dim_head
    q, k, v, g = (torch.randn(b, n, h * d, generator=gen, device="cuda").view(b, n, h, d).transpose(1, 2)
                  for _ in range(4))
    raw = rotary_freqs(n, d, device="cuda")
    rope = (torch.cos(raw), torch.sin(raw))
    key_mask, cos, sin = fa._checked(q, k, v, None, rope)
    fwd = device_ms(lambda: fa._forward_kernel(q, k, v, d ** -0.5, key_mask, cos, sin, with_lse=True))
    out, lse = fa._forward_kernel(q, k, v, d ** -0.5, key_mask, cos, sin, with_lse=True)
    bwd = device_ms(lambda: fa._backward_kernel(q, k, v, out, lse, g, d ** -0.5, key_mask, cos, sin))
    leaves = [t.detach().requires_grad_() for t in (apply_rotary_pos_emb(q, rope), apply_rotary_pos_emb(k, rope), v)]
    lib_fwd = device_ms(lambda: _sdpa(*(t.detach() for t in leaves), d ** -0.5))
    sdpa_out = _sdpa(*leaves, d ** -0.5)
    lib_bwd = device_ms(lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True), iters=5)
    calls = dcfg.depth
    print(f"K1-f32 [{b}, {h}, {n}, {d}]: device {fwd:.4f} ms, SDPA float32 {lib_fwd:.4f} ms; K2-f32: device "
          f"{bwd:.4f} ms, SDPA float32 backward {lib_bwd:.4f} ms; per duration step ({calls} calls each): "
          f"K1-f32 {calls * fwd:.3f} ms against {calls * lib_fwd:.3f}, K2-f32 {calls * bwd:.3f} ms against "
          f"{calls * lib_bwd:.3f}, lost {calls * (fwd + bwd - lib_fwd - lib_bwd):.3f} ms; on {card}")
    for label, us in host.items():
        print(f"host time per wrapper call, {label} (100 calls enqueued behind a spin kernel, 10 runs): "
              f"median {statistics.median(us):.1f} us, least {us[0]:.1f}, most {us[-1]:.1f}")

    model = F5TTS.from_pretrained(snap, device="cuda", quantization_bits=4)
    ref, duration, _ = _setup(model)

    def request():
        model.sample(ref[None], TEXT, duration=duration, steps=STEPS, method="euler", cfg_strength=2.0,
                     sway_sampling_coef=-1.0, seed=0, return_trajectory=False)

    request()
    _profiled("int4 request", request)
    del model

    gen = torch.Generator(device="cuda").manual_seed(3)
    model = F5TTS.init(gen, cfg.replace(compute_dtype="bfloat16"), device="cuda", cfm_cfg=CFMConfig())
    opt = T.make_optimizer(learning_rate=1e-4, num_warmup_steps=0, total_steps=1000)
    state = T.init_train_state(model.dit, opt, ema=True)
    batch = _train_batch(gen)
    draws = draw_cfm(gen, model.cfm_cfg, TRAIN_BATCH, TRAIN_FRAMES, 100, torch.device("cuda"))
    step = T.make_train_step(model.cfm_cfg, opt, ema_decay=0.999)
    step(state, *batch, draws=draws)
    _profiled("CFM step", lambda: step(state, *batch, draws=draws))
    del model, state

    gen = torch.Generator(device="cuda").manual_seed(6)
    dmodel = DurationPredictor.init(gen, DURATION_V2, device="cuda")
    dstate = T.init_train_state(dmodel, opt, ema=True)
    dbatch = _train_batch(gen)
    rand_frac = torch.rand(TRAIN_BATCH, generator=gen, device="cuda")
    dstep = make_duration_train_step(opt, dmodel.audio_cfg.frames_per_second, ema_decay=0.999)
    dstep(dstate, *dbatch, draws=rand_frac)
    _profiled("duration step", lambda: dstep(dstate, *dbatch, draws=rand_frac))


def main() -> int:
    card = device_phase()
    import torch

    build_phase()
    kernel = kernel_phase()
    f32_attn = f32_attention_phase()
    qmm = qmatmul_phase()
    w8a8 = w8a8_kernel_phase()
    tmp_base = "/dev/shm" if os.path.isdir("/dev/shm") and shutil.disk_usage("/dev/shm").free > 8 * 2**30 else None
    with tempfile.TemporaryDirectory(dir=tmp_base) as snap:
        snapshot_phase(snap)
        float_times, float_launches = float_path_phase(card, snap)
        q_times, q_launches = quantized_path_phase(card, snap)
        mesh_launches, mesh_rows = mesh_phase(card, snap)
        w8a8_times, w8a8_launches = w8a8_path_phase(card, snap, tmp_base)
        serve_launches, live_lat = serving_phase(card, snap)
        artifact_launches, artifact_grid_launches = artifact_phase(card, snap, tmp_base, live_lat)
        bwd = bwd_kernel_phase()
        with tempfile.TemporaryDirectory(dir=tmp_base) as tmp:
            _, cfm_ms, cfm_launches = cfm_training_phase(card, tmp)
        _, dur_ms, dur_launches = duration_training_phase(card)
        wav_launches = wav_training_phase(card, tmp_base)
        mesh_train_launches = mesh_training_phase(card, tmp_base)
        probe = probe_kernel_phase()
        probe_launches = probe_tools_phase(card)
        ranking_phase(card, snap)
    print(f"float requests: {', '.join(f'{t * 1e3:.1f} ms' for t in float_times)}; "
          f"int4 requests: {', '.join(f'{t * 1e3:.1f} ms' for t in q_times)}; "
          f"W8A8 requests: {', '.join(f'{t * 1e3:.1f} ms' for t in w8a8_times)}; "
          f"CFM step median {sorted(cfm_ms)[len(cfm_ms) // 2]:.1f} ms; "
          f"duration step median {sorted(dur_ms)[len(dur_ms) // 2]:.1f} ms; the whole run so far "
          f"{time.perf_counter() - T_START:.1f} s; on {card}")
    # launches summed over the main paths' counted runs; the probe kernels' over the probe tools' run
    paths = (float_launches, q_launches, mesh_launches, w8a8_launches, serve_launches, artifact_launches,
             artifact_grid_launches, cfm_launches, dur_launches, wav_launches, mesh_train_launches)
    launches = {k: sum(p[k] for p in paths) for k in float_launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main paths")
    launches.update(probe_launches)
    csrc = "f5_tts_tpu_torch/csrc/"
    rows = [
        ("flash_attention_fwd", "cuda", csrc + "attn_core.cuh", "f5_tts_tpu/ops/flash_attention.py:165",
         kernel["main path"]),
        ("flash_attention_fwd_f32", "cuda", csrc + "flash_attention_fwd.cu",
         "f5_tts_tpu/ops/flash_attention.py:165", f32_attn["duration training"]),
        ("qmatmul", "cuda", csrc + "qmatmul.cu", "f5_tts_tpu/ops/qmatmul.py:69",
         qmm[("to_q/k/v/out", 4, torch.bfloat16)]),
        ("qmatmul_f32", "cuda", csrc + "qmatmul.cu", "f5_tts_tpu/ops/qmatmul.py:69",
         qmm[("to_q/k/v/out", 4, torch.float32)]),
        ("flash_attention_bwd", "cuda", csrc + "flash_attention_bwd.cu", "f5_tts_tpu/ops/flash_attention.py:349",
         bwd["CFM training"]),
        ("flash_attention_bwd_f32", "cuda", csrc + "flash_attention_bwd.cu",
         "f5_tts_tpu/ops/flash_attention.py:349", bwd["duration training"]),
        ("attn_pack2", "cuda", csrc + "attn_rope_wgmma.cu", "tools/attn_variants.py:76", probe["attn_pack2"]),
        ("attn_flat", "cuda", csrc + "attn_rope_wgmma.cu", "tools/attn_variants.py:115", probe["attn_flat"]),
        ("flash_nhd", "cuda", csrc + "attn_rope_wgmma.cu", "tools/fusion_probe.py:128", probe["flash_nhd"]),
        ("flash_bhnd_rope", "cuda", csrc + "attn_rope_wgmma.cu", "tools/fusion_probe.py:165",
         probe["flash_bhnd_rope"]),
        ("ln_modulate", "triton", "f5_tts_tpu_torch/ops/ln_modulate.py", "tools/fusion_probe.py:318",
         probe["ln_modulate"]),
        ("w8a8_quantize", "triton", "f5_tts_tpu_torch/ops/w8a8.py", "f5_tts_tpu/utils/modules.py:56",
         w8a8[("quantize", "to_q/k/v/out", torch.bfloat16)]),
        ("w8a8_rescale", "triton", "f5_tts_tpu_torch/ops/w8a8.py", "f5_tts_tpu/utils/modules.py:56",
         w8a8[("rescale", "to_q/k/v/out", torch.bfloat16)]),
        ("w8a8_row_absmax", "triton", "f5_tts_tpu_torch/ops/w8a8.py", "f5_tts_tpu/utils/modules.py:56",
         mesh_rows[("row_absmax", "to_out")]),
        ("w8a8_quantize_scaled", "triton", "f5_tts_tpu_torch/ops/w8a8.py", "f5_tts_tpu/utils/modules.py:56",
         mesh_rows[("quantize_scaled", "to_out")]),
    ]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": route,
        "source": src,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": r["err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    } for name, route, src, replaces, r in rows]}))

    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
