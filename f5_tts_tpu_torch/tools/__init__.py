"""Kernel probe tools, run on the card: `attn_variants` (attention kernel
layouts and grids) and `fusion_probe` (fused RoPE attention, the attention
layer, grouped conv formulations, LayerNorm + modulate)."""
