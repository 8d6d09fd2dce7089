"""Probe tools: `attn_variants` (attention kernel layouts and grids),
`fusion_probe` (fused RoPE attention, the attention layer, grouped conv
formulations, LayerNorm + modulate) and `int8_probe` (W8A8 against bf16),
run on the card; `quant_quality` (the weight-only snapshots' distortion)
and `serve_latency` (the server's latencies)."""
