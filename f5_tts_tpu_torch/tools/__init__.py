"""Probe tools: `attn_variants` (attention kernel layouts and grids),
`fusion_probe` (fused RoPE attention, the attention layer, grouped conv
formulations, LayerNorm + modulate) and `int8_probe` (W8A8 against bf16),
run on the card; `quant_quality` (the weight-only snapshots' distortion),
`serve_latency` (the server's latencies, and with `--artifact-bench` the
artifact server's throughput), `export_verify` (exported artifacts against
the live path, on the card), `loader_bench` (the training data
pipeline's host rates) and `scaling` (mesh sampling on grids of 1 to 8
slots against 1 slot, with its reductions)."""
