"""`DiTConfig.int8_compute` in the PyTorch port, on the CPU.

The JAX package samples W8A8 (int8 weights and activations) on a config with
`int8_compute=True`, and refuses a weight-only quantized tree for it. The
port has no W8A8 yet, so it refuses such a config when it loads a snapshot
and when it samples, instead of sampling in the compute dtype with weights
the config did not ask for. A snapshot without the flag loads and samples
as before. The model is tiny (dim 64, text_dim 64, so its linears are
quantizable); the snapshots are written by the JAX package's
`save_pretrained`.
"""

import json

import jax
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
from f5_tts_tpu_torch.models.quant import quantize_module_
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


@pytest.mark.parametrize("bits", [None, 4], ids=["float", "int4"])
def test_snapshot_with_int8_compute_is_refused(tmp_path, bits):
    """A JAX-written snapshot whose config asks for W8A8: the port's loader
    raises and names W8A8; for a weight-only quantized load it also says
    why the two do not mix, as the JAX package does."""
    snap = _jax_snapshot(tmp_path, True, bits)
    with pytest.raises(NotImplementedError, match="W8A8") as err:
        F5TTS.from_pretrained(snap, device="cpu", quantization_bits=bits)
    assert "not ported" in str(err.value)
    assert ("weight-only quantized" in str(err.value)) is (bits is not None)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int4"])
def test_sample_refuses_int8_compute(quantized):
    """A model built in memory with int8_compute=True raises in sample
    rather than sampling without W8A8."""
    g = torch.Generator().manual_seed(0)
    model = F5TTS.init(g, DiTConfig(**TINY, int8_compute=True), device="cpu",
                       cfm_cfg=CFMConfig(duration_bucket=64), vocab_char_map=VOCAB,
                       vocoder=Vocos.init(g, VocosConfig(**VOCOS), device="cpu"))
    if quantized:
        quantize_module_(model.dit, 4)
    with pytest.raises(NotImplementedError, match="W8A8") as err:
        model.sample(WAVE[None], ["hello"], duration=64, steps=2, method="euler", seed=0)
    assert ("weight-only quantized" in str(err.value)) is quantized


@pytest.mark.parametrize("bits", [None, 4], ids=["float", "int4"])
def test_snapshot_without_int8_compute_loads_and_samples(tmp_path, bits):
    snap = _jax_snapshot(tmp_path, False, bits)
    model = F5TTS.from_pretrained(snap, device="cpu", quantization_bits=bits)
    assert not model.dit_cfg.int8_compute
    wave, _ = model.sample(WAVE[None], ["hello"], duration=64, steps=2, method="euler", seed=0)
    assert wave.shape == (63 * 256,) and torch.isfinite(wave).all()
