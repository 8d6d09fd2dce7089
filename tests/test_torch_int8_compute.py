"""`DiTConfig.int8_compute` in the PyTorch port, on the CPU.

Both packages sample W8A8 (int8 weights and activations) on a config with
`int8_compute=True`, and refuse a weight-only quantized DiT for it with
ValueError when they sample. A JAX snapshot whose config carries the flag
loads in the port and samples the JAX package's W8A8 wave (same `y0`,
within 1e-3 as the float pipeline's parity test); a snapshot without the
flag loads and samples as before. The model is tiny (dim 64, text_dim 64,
so its linears are quantizable); the snapshots are written by the JAX
package's `save_pretrained`.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.config import VocosConfig as JaxVocosConfig
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.vocos import Vocos as JaxVocos
from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, VocosConfig
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.quant import W8A8Linear, quantize_module_
from f5_tts_tpu_torch.models.vocos import Vocos

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
            text_num_embeds=256, text_dim=64, conv_layers=1)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {c: i for i, c in enumerate([""] + [chr(c) for c in range(ord(" "), ord(" ") + 95)])}
WAVE = (0.1 * np.sin(2 * np.pi * 220 * np.arange(6000) / 24_000)).astype(np.float32)


def _jax_snapshot(root, int8_compute: bool, bits):
    """A tiny JAX model with the flag, written by JAX's save_pretrained
    (float, or weight-only quantized with `bits`)."""
    model = JaxF5TTS.init(
        jax.random.key(0), JaxDiTConfig(**TINY, int8_compute=int8_compute),
        cfm_cfg=JaxCFMConfig(duration_bucket=64), vocab_char_map=VOCAB,
        vocoder=JaxVocos.init(jax.random.key(1), JaxVocosConfig(**VOCOS)).decode,
    )
    model.save_pretrained(root, quantization_bits=bits)
    assert json.loads((root / "config.json").read_text())["dit"]["int8_compute"] is int8_compute
    return root


def _jax_w8a8_wave(snap, y0):
    model = JaxF5TTS.from_pretrained(str(snap))
    assert model.dit_cfg.int8_compute
    wave, _ = model.sample(jnp.asarray(WAVE)[None], ["hello"], duration=64, steps=2, method="euler",
                           y0=jnp.asarray(y0))
    return np.asarray(wave)


@pytest.mark.parametrize("bits", [None, 4], ids=["float", "int4"])
def test_snapshot_with_int8_compute_samples_w8a8(tmp_path, bits):
    """A JAX-written snapshot whose config asks for W8A8 loads in the port.
    The float one samples through W8A8 linears, as the JAX package does;
    the weight-only quantized one raises ValueError when it samples, as
    the JAX package's `w8a8_blocks` does."""
    snap = _jax_snapshot(tmp_path, True, bits)
    model = F5TTS.from_pretrained(snap, device="cpu", quantization_bits=bits)
    assert model.dit_cfg.int8_compute
    y0 = np.random.default_rng(3).standard_normal((1, 64, 100)).astype(np.float32)
    if bits is not None:
        with pytest.raises(ValueError, match="weight-only quantized"):
            model.sample(WAVE[None], ["hello"], duration=64, steps=2, method="euler", y0=y0)
        return
    wave, _ = model.sample(WAVE[None], ["hello"], duration=64, steps=2, method="euler", y0=y0)
    assert all(isinstance(blk.attn.to_v, W8A8Linear) for blk in model._inference_dit().transformer_blocks)
    np.testing.assert_allclose(wave.numpy(), _jax_w8a8_wave(snap, y0), atol=1e-3, rtol=0)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int4"])
def test_sample_with_int8_compute(quantized):
    """A model built in memory with int8_compute=True samples W8A8 (its
    output differs from the same model's without the flag); on a
    weight-only quantized DiT it raises ValueError."""
    g = torch.Generator().manual_seed(0)
    model = F5TTS.init(g, DiTConfig(**TINY, int8_compute=True), device="cpu",
                       cfm_cfg=CFMConfig(duration_bucket=64), vocab_char_map=VOCAB,
                       vocoder=Vocos.init(g, VocosConfig(**VOCOS), device="cpu"))
    if quantized:
        quantize_module_(model.dit, 4)
        with pytest.raises(ValueError, match="weight-only quantized"):
            model.sample(WAVE[None], ["hello"], duration=64, steps=2, method="euler", seed=0)
        return
    w8a8, _ = model.sample(WAVE[None], ["hello"], duration=64, steps=2, method="euler", seed=0)
    model.dit_cfg = model.dit_cfg.replace(int8_compute=False)
    plain, _ = model.sample(WAVE[None], ["hello"], duration=64, steps=2, method="euler", seed=0)
    assert torch.isfinite(w8a8).all() and w8a8.shape == plain.shape
    assert not torch.equal(w8a8, plain)


@pytest.mark.parametrize("bits", [None, 4], ids=["float", "int4"])
def test_snapshot_without_int8_compute_loads_and_samples(tmp_path, bits):
    snap = _jax_snapshot(tmp_path, False, bits)
    model = F5TTS.from_pretrained(snap, device="cpu", quantization_bits=bits)
    assert not model.dit_cfg.int8_compute
    wave, _ = model.sample(WAVE[None], ["hello"], duration=64, steps=2, method="euler", seed=0)
    assert wave.shape == (63 * 256,) and torch.isfinite(wave).all()
