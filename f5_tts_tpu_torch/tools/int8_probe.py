"""Time the W8A8 int8-compute linear against bf16 at the DiT's linear
shapes on the card: the counterpart of the JAX package's
`tools/int8_probe.py`.

    PYTHONPATH=. python -m f5_tts_tpu_torch.tools.int8_probe

At [2048, k] x [k, n] for (k, n) in (1024, 1024), (1024, 2048),
(2048, 1024) and (1024, 3072): bf16 `F.linear`, `torch._int_mm` alone on
int8 operands (the product W8A8 runs, on w8 stored [out, in]; and on w8
stored [in, out], the layout W8A8 does not use), and the W8A8 linear end to end
(ops/w8a8.py `w8a8_linear`: quantize_rows, torch._int_mm, rescale_bias),
each as CUDA-event times: the least of REPS times of one call (host launch
included) and the device time of one call (ITERS calls enqueued behind a
spin kernel, so the host's enqueue is left out). Then the cost of CFG's
concatenate([x, x]) per flow evaluation at [1, 1024, 100] float32, as the
JAX tool measures it. The JAX tool's scan-minus-baseline timing is a TPU
workaround and is not carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from f5_tts_tpu_torch.ops.w8a8 import w8a8_linear
from f5_tts_tpu_torch.tools._timing import best_ms, cuda_device, device_ms

M = 2048
SHAPES = ((1024, 1024), (1024, 2048), (2048, 1024), (1024, 3072))
REPS = 30
ITERS = 50


def main(reps: int = REPS, device: torch.device | str = "cuda") -> dict:
    """Print and return, per shape, {label: (best ms, device ms)} and the
    concat probe's us per evaluation."""
    dev = cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"W8A8 against bf16 on {torch.cuda.get_device_name(dev)}: least of {reps} CUDA-event times of one call "
          f"(host launch included) / device time of one call ({ITERS} behind a spin kernel)")
    results = {}
    for k, n in SHAPES:
        x = torch.randn(M, k, generator=gen, device=dev, dtype=torch.bfloat16)
        w = (torch.randn(n, k, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        bias = torch.randn(n, generator=gen, device=dev, dtype=torch.bfloat16)
        xq = torch.randint(-127, 128, (M, k), generator=gen, device=dev, dtype=torch.int8)
        w8 = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        w8_scale = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        w8_in_out = w8.t().contiguous()
        runs = {"bf16 F.linear": lambda: F.linear(x, w, bias),
                "int8 _int_mm": lambda: torch._int_mm(xq, w8.t()),
                "int8 _int_mm, w8 [in, out]": lambda: torch._int_mm(xq, w8_in_out),
                "w8a8 e2e": lambda: w8a8_linear(x, w8, w8_scale, bias)}
        row = {label: (best_ms(run, reps), device_ms(run, ITERS)) for label, run in runs.items()}
        ops = 2 * M * k * n
        print(f"[{M},{k}]x[{k},{n}]  " + "  ".join(
            f"{label} {ms:.4f} / {dev_ms:.4f} ms ({ops / dev_ms / 1e9:.1f} T/s)" for label, (ms, dev_ms) in row.items())
            + f"  w8a8/bf16 device {row['w8a8 e2e'][1] / row['bf16 F.linear'][1]:.2f}x")
        results[(M, k, n)] = row

    # CFG keeps cond and uncond in one batch: what concatenate([x, x]) costs a flow evaluation
    b, frames, mel = 1, 1024, 100
    x0 = torch.randn(b, frames, mel, generator=gen, device=dev)

    def with_cat():
        y2 = torch.cat([x0, x0]) * 1.0001 + 0.001  # stand-in for the DiT call, timed above
        pred, null = y2[:b], y2[b:]
        return pred + (pred - null) * 2.0

    def without_cat():
        y = x0 * 1.0001 + 0.001
        return y + (y - y * 0.999) * 2.0

    t_cat, t_no = device_ms(with_cat, ITERS), device_ms(without_cat, ITERS)
    extra_us = max(t_cat - t_no, 0.0) * 1e3
    print(f"concat([x,x]) {b}x{frames}x{mel}: {extra_us:.1f} us/eval (cat {t_cat * 1e3:.1f} us, "
          f"nocat {t_no * 1e3:.1f} us; x32 steps = {extra_us * 32 / 1e3:.3f} ms per request)")
    results["concat_us_per_eval"] = extra_us
    return results


if __name__ == "__main__":
    main()
