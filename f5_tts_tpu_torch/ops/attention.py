"""Scaled dot-product attention: the plain version and the dispatch.

Non-causal with an optional key-padding mask, which is the only masking the
model needs. `flash_attention` (ops/flash_attention.py) launches the
hand-written kernel for a CUDA tensor and runs the plain version for a CPU
tensor.
"""

from __future__ import annotations

import torch


def sdpa_reference(
    q: torch.Tensor,  # [b, h, n, d]
    k: torch.Tensor,  # [b, h, n, d]
    v: torch.Tensor,  # [b, h, n, d]
    scale: float,
    key_mask: torch.Tensor | None = None,  # [b, n] bool, True = keep
) -> torch.Tensor:
    """Plain attention: logits and softmax in float32, output in q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        neg = torch.finfo(torch.float32).min
        logits = logits.masked_fill(~key_mask[:, None, None, :], neg)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    key_mask: torch.Tensor | None = None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,  # (cos, sin) [n', rot_dim]
    q_offset: int = 0,  # a query block's first row among k's (ops/flash_attention.py)
    rope_heads: int | None = None,  # the rotated heads, the first ones; None: every head
) -> torch.Tensor:
    """Attention after the interleaved rotary embedding of q and k (of the
    first `rope_heads` heads, or of every head). A rotation of the full head
    goes into the kernel with the last n_k table rows (the keys'; a query
    block takes its rows from q_offset of those); a partial one is applied
    here first."""
    from f5_tts_tpu_torch.ops.flash_attention import _rotated, flash_attention

    if rope is not None:
        cos, sin = rope
        n_k = k.shape[-2]
        if cos.shape[-1] == q.shape[-1]:
            rope = (cos[-n_k:], sin[-n_k:])
        else:
            q, k = _rotated(q, k, rope, q_offset, rope_heads)
            rope = None
    return flash_attention(q, k, v, scale, key_mask=key_mask, rope=rope, q_offset=q_offset, rope_heads=rope_heads)
