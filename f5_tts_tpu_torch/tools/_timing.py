"""CUDA-event timing and the device check shared by the probe tools."""

from __future__ import annotations

import torch

HOLD_CYCLES = 50_000_000  # the spin kernel before a device-timed run: about 25 ms at the H100's 1.98 GHz


def cuda_device(device: torch.device | str) -> torch.device:
    """The probes time on a CUDA device only; anything else raises."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the probe tools time kernels on a CUDA device; got {device!r} "
                           f"(CUDA available: {torch.cuda.is_available()})")
    return dev


def best_ms(run, reps: int) -> float:
    """The least of `reps` CUDA-event times of `run()`, in ms, after one
    warm-up call. Events bracket the host's enqueue too, so launch time is
    included whenever the card outruns the host."""
    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def device_ms(run, iters: int = 50, warmup: int = 1) -> float:
    """The mean device time of one `run()` over `iters` back-to-back calls
    enqueued behind a spin kernel (so the host's enqueue is left out),
    after `warmup` calls."""
    for _ in range(warmup):
        run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
