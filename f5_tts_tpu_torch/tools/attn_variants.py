"""Time the attention kernel variants on the card: the counterpart of the JAX
package's `tools/attn_variants.py`.

    PYTHONPATH=. python -m f5_tts_tpu_torch.tools.attn_variants

At [2, 16, 1024, 64] bf16, no mask and no rotary embedding, five variants:
the port's attention forward (K1, which without a mask or RoPE runs the
TMA + wgmma attention core alone), `attn_flat` and `attn_pack2` (the
counterparts of the Pallas kernels' flat b * h grid and two-heads-a-step
grid; both run the same core, 128 query rows of one head per block), the
unfused plain version, and PyTorch's
scaled_dot_product_attention as a yardstick only. Prints each one's time
(the least of REPS CUDA-event times of one call, launch included) and its
largest error against the unfused version.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from f5_tts_tpu_torch.ops.attention import sdpa_reference
from f5_tts_tpu_torch.ops.attn_variants import attn_flat, attn_pack2
from f5_tts_tpu_torch.ops.flash_attention import flash_attention
from f5_tts_tpu_torch.tools._timing import best_ms, cuda_device

B, H, N, D = 2, 16, 1024, 64
SCALE = 1.0 / math.sqrt(D)
REPS = 30
UNFUSED = "unfused (plain)"


def variants(scale: float) -> dict:
    """name -> fn(q, k, v) over [b, h, n, d]."""
    return {
        "current (K1, b,h,q grid)": lambda q, k, v: flash_attention(q, k, v, scale),
        "flat (b*h grid)": lambda q, k, v: attn_flat(q, k, v, scale),
        "pack2 (TMA/wgmma core)": lambda q, k, v: attn_pack2(q, k, v, scale),
        UNFUSED: lambda q, k, v: sdpa_reference(q, k, v, scale),
        "torch sdpa (yardstick)": lambda q, k, v: F.scaled_dot_product_attention(q, k, v, scale=scale),
    }


def main(reps: int = REPS, device: torch.device | str = "cuda") -> dict[str, tuple[float, float]]:
    """Time every variant; returns name -> (ms, max error against the
    unfused version)."""
    dev = cuda_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, H, N, D, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(3))
    fns = variants(SCALE)
    ref = fns[UNFUSED](q, k, v).float()
    results = {}
    print(f"attention variants at [{B}, {H}, {N}, {D}] bf16 on {torch.cuda.get_device_name(dev)}; "
          f"least of {reps} CUDA-event times of one call, host launch included")
    for name, fn in fns.items():
        err = (fn(q, k, v).float() - ref).abs().max().item()
        ms = best_ms(lambda: fn(q, k, v), reps)
        print(f"{name:28} {ms:8.4f} ms   maxerr {err:.4f}")
        results[name] = (ms, err)
    return results


if __name__ == "__main__":
    main()
