"""The offline snapshot loader of the PyTorch port against the JAX package,
on the CPU: sha256 pinning (`utils/hub.py`, `expected_sha256=`), the
digest printer, and the vocoder loader's three file names (R8:
`model.safetensors`, `pytorch_model.bin`, `weights.safetensors`, tried in
that order, as the JAX `load_vocos_pretrained` does).

Snapshots are written by the JAX package's `save_pretrained` (tiny DiT: dim
64, depth 2, 2 heads x 32, text_dim 32; Vocos at dim 32, 2 layers;
64-frame buckets). Where both packages sample, they share `y0`; the wave
is held within 1e-3, the float pipeline parity test's tolerance.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

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
from f5_tts_tpu.utils import hub as jax_hub
from f5_tts_tpu_torch.config import VocosConfig
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.convert import load_vocos_pretrained
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.utils import hub

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
            text_num_embeds=256, text_dim=32, conv_layers=1)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {c: i for i, c in enumerate([""] + [chr(c) for c in range(ord(" "), ord(" ") + 95)])}
WAVE = (0.1 * np.sin(2 * np.pi * 220 * np.arange(6000) / 24_000)
        + 0.01 * np.random.default_rng(4).standard_normal(6000)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("snap")
    JaxF5TTS.init(
        jax.random.key(0), JaxDiTConfig(**TINY, use_flash_attention=False),
        cfm_cfg=JaxCFMConfig(duration_bucket=64), vocab_char_map=VOCAB,
        vocoder=JaxVocos.init(jax.random.key(1), JaxVocosConfig(**VOCOS)).decode,
    ).save_pretrained(str(root))
    return root


def _copy_snapshot(src: Path, dst: Path) -> Path:
    for p in src.rglob("*"):
        if p.is_file():
            (dst / p.relative_to(src)).parent.mkdir(parents=True, exist_ok=True)
            (dst / p.relative_to(src)).write_bytes(p.read_bytes())
    return dst


@pytest.mark.parametrize("vocos_file", ["weights.safetensors", "pytorch_model.bin"])
def test_vocoder_loads_from_every_file_name(jax_snapshot, tmp_path, vocos_file):
    """R8: the snapshot's vocoder as weights.safetensors (the JAX file
    renamed) or as pytorch_model.bin (torch.save of the torch-named state);
    both packages load it and sample the same wave with a shared y0."""
    snap = _copy_snapshot(jax_snapshot, tmp_path)
    original = F5TTS.from_pretrained(snap, device="cpu").vocoder.state_dict()
    vocos_dir = snap / "vocos"
    if vocos_file == "weights.safetensors":
        os.replace(vocos_dir / "model.safetensors", vocos_dir / vocos_file)
    else:
        torch.save(original, vocos_dir / vocos_file)
        (vocos_dir / "model.safetensors").unlink()
    assert sorted(p.name for p in vocos_dir.iterdir()) == [vocos_file]

    port = F5TTS.from_pretrained(snap, device="cpu")
    for k, v in port.vocoder.state_dict().items():
        torch.testing.assert_close(v, original[k], rtol=0, atol=0)
    ref = JaxF5TTS.from_pretrained(str(snap))
    y0 = np.random.default_rng(1).standard_normal((1, 64, 100)).astype(np.float32)
    kw = dict(duration=64, steps=2, method="euler", cfg_strength=2.0)
    want, _ = ref.sample(jnp.asarray(WAVE)[None], ["hello"], y0=jnp.asarray(y0), **kw)
    got, _ = port.sample(WAVE[None], ["hello"], y0=y0, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_vocoder_file_order_and_absence(jax_snapshot, tmp_path):
    """model.safetensors wins over the other two names; a directory with
    none of them raises FileNotFoundError naming all three."""
    snap = _copy_snapshot(jax_snapshot, tmp_path)
    cfg = VocosConfig(**VOCOS)
    first = load_vocos_pretrained(snap / "vocos", cfg, device="cpu")
    torch.save({k: torch.zeros_like(v) for k, v in first.state_dict().items()}, snap / "vocos" / "pytorch_model.bin")
    again = load_vocos_pretrained(snap / "vocos", cfg, device="cpu")
    for k, v in again.state_dict().items():
        torch.testing.assert_close(v, first.state_dict()[k], rtol=0, atol=0)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        load_vocos_pretrained(empty, cfg, device="cpu")


def test_vocos_from_pretrained_decodes_as_the_jax_vocoder(jax_snapshot):
    """`Vocos.from_pretrained` on the snapshot's vocos/ directory decodes a
    mel as the JAX `Vocos.from_pretrained` of the same directory (whose
    published config it assumes, so both take the snapshot's tiny one here
    through `load_vocos_pretrained`)."""
    from f5_tts_tpu.models.convert import load_vocos_pretrained as jax_load_vocos

    vocos = Vocos.from_pretrained(jax_snapshot / "vocos", VocosConfig(**VOCOS), device="cpu")
    ref = jax_load_vocos(str(jax_snapshot / "vocos"), JaxVocosConfig(**VOCOS))
    mel = np.random.default_rng(2).standard_normal((1, 40, 100)).astype(np.float32)
    got = vocos.decode(torch.tensor(mel))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref.decode(jnp.asarray(mel))), atol=1e-3, rtol=0)


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hub.sha256_file(p) for p in sorted(root.rglob("*")) if p.is_file()}


def test_expected_sha256_pins_the_snapshot(jax_snapshot, tmp_path):
    """A right digest loads; a wrong digest and a missing file raise
    ValueError naming the file, as the JAX loader does; the digest is
    hashlib's."""
    import hashlib

    digests = _digests(jax_snapshot)
    assert digests["config.json"] == hashlib.sha256((jax_snapshot / "config.json").read_bytes()).hexdigest()
    pins = {k: digests[k] for k in ("model_v1.safetensors", "vocos/model.safetensors")}
    model = F5TTS.from_pretrained(jax_snapshot, device="cpu", expected_sha256={k: v.upper() for k, v in pins.items()})
    assert model.vocoder is not None
    bad = {**pins, "model_v1.safetensors": "0" * 64}
    for expected, match in ((bad, "digest mismatch for model_v1.safetensors"),
                            ({**pins, "duration_v2.safetensors": "0" * 64}, "missing from snapshot: duration_v2")):
        with pytest.raises(ValueError, match=match):
            F5TTS.from_pretrained(jax_snapshot, device="cpu", expected_sha256=expected)
        with pytest.raises(ValueError, match=match):
            JaxF5TTS.from_pretrained(str(jax_snapshot), expected_sha256=expected)
    with pytest.raises(ValueError, match="not a directory"):
        F5TTS.from_pretrained(tmp_path / "no-such-dir", device="cpu")


def test_digest_printer_matches_jax(jax_snapshot, capsys):
    """`python -m f5_tts_tpu_torch.utils.hub <dir>` prints the JAX `main`'s
    JSON for the same directory."""
    jax_hub.main([str(jax_snapshot)])
    want = capsys.readouterr().out
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    got = subprocess.run([sys.executable, "-m", "f5_tts_tpu_torch.utils.hub", str(jax_snapshot)], env=env,
                         capture_output=True, text=True, check=True, timeout=120).stdout
    assert got == want
    assert json.loads(got) == _digests(jax_snapshot)
