"""Exported artifacts against the live path on the card: the port of the JAX
package's `tools/export_verify.py`.

    PYTHONPATH=. python -m f5_tts_tpu_torch.tools.export_verify

  1. a small model (dim 256 x depth 4, 4 heads of 64, bf16, with Vocos):
     the sampler with its weights in the program and beside it, and the
     same sampler exported on the CPU and moved to the card (its registered
     operators then launch the kernels), each saved, loaded and called at
     seed 7 against `F5TTS.sample(seed=7)`; the duration artifact against
     the live forward over the same window;
  2. the base config (1024 x 22 layers x 16 heads of 64, bf16, no
     vocoder): the external-weights sampler against the live mel.

Each check prints the largest relative L2 over the rows (the mel and the
wave) beside its tolerance and the launches of K1; artifacts exported on
the card run the live path's operators on the same weights and noise and
come out equal, the one moved from the CPU is held to the served group's
tolerances (chip_smoke.py SERVE_TOL). Exit code 0 iff every check passes.
The device must be a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

TOL = {"mel": 5e-3, "wave": 1.5e-2}  # relative L2 of a row; chip_smoke.py SERVE_TOL
FAILURES: list[str] = []


def check(name: str, errs: dict, tol: dict) -> None:
    ok = all(errs[k] <= tol[k] for k in errs)
    print(f"{'PASS' if ok else 'FAIL'}  {name}: " + ", ".join(f"{k} {v:.3e} (tol {tol[k]:.0e})"
                                                         for k, v in errs.items()), flush=True)
    if not ok:
        FAILURES.append(name)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return max(((x.float() - y.float()).norm() / y.float().norm()).item() for x, y in zip(a, b))


def _roundtrip(export, save, load, path: str):
    t0 = time.perf_counter()
    exp = export()
    t1 = time.perf_counter()
    save(exp, path)
    t2 = time.perf_counter()
    out = load(path)
    print(f"  export {t1 - t0:.1f} s ({len(exp.program.graph.nodes)} nodes), save {t2 - t1:.1f} s "
          f"({os.path.getsize(path) / 2**20:.1f} MiB), load {time.perf_counter() - t2:.1f} s", flush=True)
    return out


def _sampler_check(name, model, sampler, spec, cond, text, dur, steps, tol, mel_only=False):
    from f5_tts_tpu_torch import export as E
    from f5_tts_tpu_torch.ops.flash_attention import flash_attention

    args = E.prep_inputs(spec, cond, text, dur, seed=7)
    before = flash_attention.launches
    out = sampler.call(*args)
    torch.cuda.synchronize()
    k1 = flash_attention.launches - before
    live, traj = model.sample(torch.as_tensor(cond, device=model.device), text, duration=dur, steps=steps,
                              method="euler", seed=7, return_trajectory=False)
    max_dur = int(args[3])
    if mel_only:
        errs = {"mel": _rel(out[:, :max_dur], live)}
    else:
        mel, wave = out
        lens = args[1]
        errs = {"mel": _rel([mel[i, r:max_dur] for i, r in enumerate(lens)],
                            [traj[0, i, r:max_dur] for i, r in enumerate(lens)]),
                "wave": _rel(wave[:, :(max_dur - 1) * model.audio_cfg.hop_length], live)}
    print(f"  K1 launches in the call: {k1}", flush=True)
    check(name, errs, tol)


def main(argv: list[str] | None = None) -> int:
    from f5_tts_tpu_torch import export as E
    from f5_tts_tpu_torch.config import F5TTS_V1_BASE, CFMConfig, DiTConfig, DurationConfig, VocosConfig
    from f5_tts_tpu_torch.models.cfm import F5TTS
    from f5_tts_tpu_torch.models.duration import DurationPredictor
    from f5_tts_tpu_torch.models.vocos import Vocos
    from f5_tts_tpu_torch.tools._timing import cuda_device

    ap = argparse.ArgumentParser(description="exported artifacts against the live path on the card")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = cuda_device(args.device)
    print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    rng = np.random.RandomState(0)
    exact = {"mel": 0.0, "wave": 0.0}

    # -- 1. small model
    small = DiTConfig(dim=256, depth=4, heads=4, dim_head=64, ff_mult=2, text_dim=128, conv_layers=1,
                      compute_dtype="bfloat16")
    model = F5TTS.init(gen, small, device=device, cfm_cfg=CFMConfig(),
                       vocoder=Vocos.init(gen, VocosConfig(dim=128, intermediate_dim=256, num_layers=2,
                                                           compute_dtype="bfloat16"), device=device))
    batch, frames, dur, steps = 2, 96, 224, 4
    cond = (rng.randn(batch, frames, 100) * 0.1).astype(np.float32)
    text = np.full((batch, 48), -1, np.int32)
    text[0, :7] = [5, 6, 7, 8, 9, 10, 11]
    text[1, :3] = [1, 2, 3]
    with tempfile.TemporaryDirectory() as d:
        for name, embed in (("embedded weights", True), ("external weights", False)):
            print(f"small sampler, {name}:", flush=True)
            s, spec = _roundtrip(
                lambda embed=embed: E.export_sampler(model, batch=batch, steps=steps, method="euler",
                                                     embed_weights=embed),
                lambda exp, p: E.save_sampler(exp, p, model=model), E.load_sampler, f"{d}/{embed}.bin")
            _sampler_check(f"small sampler ({name}) against live", model, s, spec, cond, text, dur, steps, exact)

        print("small sampler exported on the CPU, loaded onto the card:", flush=True)
        cpu_model = F5TTS(model.dit.to("cpu"), small, cfm_cfg=model.cfm_cfg, vocoder=model.vocoder.to("cpu"))
        s, spec = _roundtrip(
            lambda: E.export_sampler(cpu_model, batch=batch, steps=steps, method="euler", embed_weights=False),
            lambda exp, p: E.save_sampler(exp, p, model=cpu_model),
            lambda p: E.load_sampler(p, device=device), f"{d}/cpu.bin")
        model = F5TTS(cpu_model.dit.to(device), small, cfm_cfg=cpu_model.cfm_cfg, vocoder=cpu_model.vocoder.to(device))
        _sampler_check("small sampler (exported on the CPU) against live on the card", model, s, spec, cond, text,
                       dur, steps, TOL)

        print("duration predictor (window 128, bf16):", flush=True)
        dp = DurationPredictor.init(gen, DurationConfig(dim=256, depth=2, heads=4, dim_head=64, ff_mult=2,
                                                        text_dim=128, conv_layers=1, compute_dtype="bfloat16"),
                                    device=device)
        s, spec = _roundtrip(lambda: E.export_duration(dp, padded_len=128),
                             lambda exp, p: E.save_duration(exp, p, predictor=dp), E.load_duration, f"{d}/dur.bin")
        mel = (rng.randn(1, 96, 100) * 0.1).astype(np.float32)
        dargs = E.prep_duration_inputs(spec, mel, text[:1, :16], lens=np.array([96], np.int32))
        got = float(s.call(*dargs)[0])
        with torch.inference_mode():
            live = float(dp.seconds(*(torch.as_tensor(a, device=device) for a in dargs))[0])
        print(f"  artifact {got:.6f} s, live {live:.6f} s", flush=True)
        check("duration artifact against the live forward", {"seconds": abs(got - live) / abs(live)},
              {"seconds": 0.0})

    # -- 2. base config, external weights, no vocoder
    print("base sampler (1024 x 22, external weights, mel only):", flush=True)
    base = F5TTS.init(gen, F5TTS_V1_BASE.replace(compute_dtype="bfloat16"), device=device, cfm_cfg=CFMConfig())
    cond1 = (rng.randn(1, 96, 100) * 0.1).astype(np.float32)
    text1 = np.full((1, 48), -1, np.int32)
    text1[0, :9] = np.arange(10, 19)
    with tempfile.TemporaryDirectory() as d:
        s, spec = _roundtrip(
            lambda: E.export_sampler(base, batch=1, steps=steps, method="euler", with_vocoder=False,
                                     embed_weights=False),
            lambda exp, p: E.save_sampler(exp, p, model=base), E.load_sampler, f"{d}/base.bin")
        _sampler_check("base sampler (external weights) against live", base, s, spec, cond1, text1, dur, steps,
                       {"mel": 0.0}, mel_only=True)

    print("ALL PASS" if not FAILURES else f"FAILED: {FAILURES}", flush=True)
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
