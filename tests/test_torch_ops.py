"""The PyTorch port's primitives, attention, audio front-end and snapshot
format against the JAX package, on the CPU in float32.

Inputs are made with numpy from a seed and fed to both sides. Tolerances:
1e-5 absolute per primitive (the same float32 math in another order), looser
where a step amplifies rounding (stated per test).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.audio.istft import istft as jax_istft
from f5_tts_tpu.audio.mel import hanning as jax_hanning
from f5_tts_tpu.audio.mel import log_mel_spectrogram as jax_log_mel
from f5_tts_tpu.config import VocosConfig as JaxVocosConfig
from f5_tts_tpu.models import rope as jrope
from f5_tts_tpu.models.vocos import init_vocos, vocos_decode
from f5_tts_tpu.ops.attention import sdpa_reference as jax_sdpa
from f5_tts_tpu.ops.flash_attention import flash_attention as jax_flash
from f5_tts_tpu.utils import modules as jm
from f5_tts_tpu_torch.audio.istft import istft
from f5_tts_tpu_torch.audio.mel import hanning, log_mel_spectrogram
from f5_tts_tpu_torch.config import VocosConfig
from f5_tts_tpu_torch.models import rope as trope
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.ops.attention import sdpa_reference, scaled_dot_product_attention
from f5_tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from f5_tts_tpu_torch.utils import modules as tm
from f5_tts_tpu_torch.utils import safetensors as st

ATOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t: torch.Tensor, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


# ------------------------------------------------------------------ primitives


def test_linear_layer_norm_activations():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 7, 16)
    w, b = _rand(rng, 16, 24), _rand(rng, 24)
    scale, bias = _rand(rng, 16), _rand(rng, 16)
    _close(tm.linear(torch.tensor(x), torch.tensor(w.T), torch.tensor(b)),
           jm.linear({"kernel": w, "bias": b}, x))
    _close(tm.layer_norm(torch.tensor(x * 3 + 1), torch.tensor(scale), torch.tensor(bias)),
           jm.layer_norm(x * 3 + 1, {"scale": scale, "bias": bias}))
    _close(tm.layer_norm(torch.tensor(x)), jm.layer_norm(x))
    _close(tm.mish(torch.tensor(x)), jm.mish(x))
    _close(tm.gelu(torch.tensor(x)), jm.gelu(x))
    _close(tm.gelu(torch.tensor(x), approximate=True), jm.gelu(x, approximate=True))


def test_embedding_clamps_out_of_range_ids():
    rng = np.random.default_rng(1)
    table = _rand(rng, 10, 8)
    ids = np.array([[0, 3, 9, 12, -2]], np.int64)
    _close(tm.embedding(torch.tensor(table), torch.tensor(ids)),
           jm.embedding({"embedding": table}, jnp.asarray(ids, jnp.int32)), atol=0)


@pytest.mark.parametrize("groups,k,padding", [(1, 7, 3), (16, 31, None), (64, 7, 3)])
def test_conv1d(groups, k, padding):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 40, 64)
    kern, b = _rand(rng, k, 64 // groups, 64) * 0.2, _rand(rng, 64)
    got = tm.conv1d(torch.tensor(x), torch.tensor(kern.transpose(2, 1, 0)), torch.tensor(b),
                    groups=groups, padding=padding)
    ref = jm.conv1d({"kernel": kern, "bias": b}, x, groups=groups,
                    padding="SAME" if padding is None else padding)
    _close(got, ref)


# ------------------------------------------------------------------ rope


def test_rope_tables_and_rotation():
    rng = np.random.default_rng(3)
    _close(trope.rotary_freqs(50, 32), jrope.rotary_freqs(50, 32), atol=1e-3)
    x = _rand(rng, 2, 3, 20, 32)
    _close(trope.rotate_half(torch.tensor(x)), jrope.rotate_half(x), atol=0)
    freqs = _rand(rng, 24, 16)  # partial rotation of the first 16 lanes, last 20 rows
    _close(trope.apply_rotary_pos_emb(torch.tensor(x), torch.tensor(freqs)),
           jrope.apply_rotary_pos_emb(x, freqs))
    cos, sin = np.cos(freqs), np.sin(freqs)
    _close(trope.apply_rotary_pos_emb(torch.tensor(x), (torch.tensor(cos), torch.tensor(sin))),
           jrope.apply_rotary_pos_emb(x, (cos, sin)))
    np.testing.assert_array_equal(trope.precompute_freqs_cis(32, 100), jrope.precompute_freqs_cis(32, 100))
    start = np.array([0, 5])
    np.testing.assert_array_equal(
        trope.get_pos_embed_indices(torch.tensor(start), 12, max_pos=10).numpy(),
        np.asarray(jrope.get_pos_embed_indices(jnp.asarray(start), 12, max_pos=10)),
    )


# ------------------------------------------------------------------ attention


def _attn_inputs(n, seed=4):
    rng = np.random.default_rng(seed)
    q, k, v = (_rand(rng, 2, 2, n, 64) for _ in range(3))
    raw = np.asarray(jrope.rotary_freqs(n, 64))
    mask = np.arange(n)[None, :] < np.array([n - 10, n])[:, None]
    return q, k, v, np.cos(raw), np.sin(raw), mask


@pytest.mark.parametrize("n", [48, 37])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_rope", [False, True])
def test_flash_plain_matches_jax_pallas_kernel(n, with_mask, with_rope):
    """K1's plain version against the JAX Pallas kernel itself (interpret
    mode on the CPU), at a block-aligned and a ragged n."""
    q, k, v, cos, sin, mask = _attn_inputs(n)
    jm_ = jnp.asarray(mask) if with_mask else None
    jr = (jnp.asarray(cos), jnp.asarray(sin)) if with_rope else None
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125, jm_, rope=jr)
    tmask = torch.tensor(mask) if with_mask else None
    trope_ = (torch.tensor(cos), torch.tensor(sin)) if with_rope else None
    args = [torch.tensor(a) for a in (q, k, v)]
    _close(flash_attention_plain(*args, 0.125, tmask, trope_), ref)
    # the wrapper on CPU tensors is the plain version
    _close(flash_attention(*args, 0.125, key_mask=tmask, rope=trope_), ref)


def test_sdpa_reference_fully_masked_row_and_partial_rope():
    """A fully masked row averages v uniformly on both sides; a rotation of
    part of the head is applied before the kernel by the dispatch."""
    q, k, v, cos, sin, _ = _attn_inputs(16, seed=5)
    mask = np.zeros((2, 16), bool)
    mask[1, :5] = True
    _close(sdpa_reference(*(torch.tensor(a) for a in (q, k, v)), 0.125, torch.tensor(mask)),
           jax_sdpa(q, k, v, 0.125, jnp.asarray(mask)))
    np.testing.assert_allclose(
        sdpa_reference(*(torch.tensor(a) for a in (q, k, v)), 0.125, torch.tensor(mask))[0].numpy(),
        np.broadcast_to(v[0].mean(axis=1, keepdims=True), v[0].shape), atol=ATOL)
    half = (torch.tensor(cos[:, :32]), torch.tensor(sin[:, :32]))
    qr = jrope.apply_rotary_pos_emb(q, (cos[:, :32], sin[:, :32]))
    kr = jrope.apply_rotary_pos_emb(k, (cos[:, :32], sin[:, :32]))
    _close(scaled_dot_product_attention(*(torch.tensor(a) for a in (q, k, v)), 0.125, rope=half),
           jax_sdpa(qr, kr, v, 0.125))


def test_flash_wrapper_rejects_other_devices():
    q = torch.zeros(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention(q, q, q, 0.125)


# ------------------------------------------------------------------ audio


def test_log_mel_matches_jax():
    """Tolerance 1e-4: log of FFT magnitudes summed in another order."""
    rng = np.random.default_rng(6)
    audio = (0.1 * rng.standard_normal((2, 24_000 // 3 + 17))).astype(np.float32)
    got = log_mel_spectrogram(torch.tensor(audio))
    ref = jax_log_mel(jnp.asarray(audio))
    assert got.shape == ref.shape
    _close(got, ref, atol=1e-4)
    np.testing.assert_array_equal(hanning(1024), jax_hanning(1024))


@pytest.mark.parametrize("valid_frames", [None, 9])
def test_istft_valid_frames_matches_jax(valid_frames):
    """Relative tolerance 1e-5 besides 1e-5 absolute: past the last valid
    frame the envelope is small and the division makes samples large."""
    rng = np.random.default_rng(7)
    spec = (rng.standard_normal((2, 12, 513)) + 1j * rng.standard_normal((2, 12, 513))).astype(np.complex64)
    window = jax_hanning(1024)
    got = istft(torch.tensor(spec), torch.tensor(window), 1024, 256, valid_frames=valid_frames)
    ref = jax_istft(jnp.asarray(spec), jnp.asarray(window), 1024, 256,
                    valid_frames=None if valid_frames is None else jnp.int32(valid_frames))
    _close(got, ref, rtol=1e-5)


def test_vocos_decode_matches_jax():
    """Tolerance 1e-4 absolute and 1e-5 relative on the wave: float32 convs
    and a magnitude exp ahead of the ISTFT, whose envelope division makes the
    samples past the last valid frame large."""
    jcfg = JaxVocosConfig(dim=32, intermediate_dim=64, num_layers=2)
    tcfg = VocosConfig(dim=32, intermediate_dim=64, num_layers=2)
    jparams = init_vocos(jax.random.key(0), jcfg)
    vocos = Vocos(tcfg)
    vocos.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    rng = np.random.default_rng(8)
    mel = rng.standard_normal((2, 20, 100)).astype(np.float32)
    mel[:, 14:] = 0.0
    for vf in (None, 14):
        got = vocos.decode(torch.tensor(mel), valid_frames=vf)
        ref = vocos_decode(jparams, jcfg, jnp.asarray(mel), valid_frames=None if vf is None else jnp.int32(vf))
        _close(got, ref, atol=1e-4, rtol=1e-5)


# ------------------------------------------------------------------ snapshots


def test_safetensors_reader_writer_match_the_package(tmp_path):
    from safetensors.numpy import load_file as ref_load
    from safetensors.numpy import save_file as ref_save

    rng = np.random.default_rng(9)
    tensors = {
        "a.weight": _rand(rng, 3, 5),
        "b": np.arange(7, dtype=np.int64),
        "c.scalarish": _rand(rng, 1),
        "d": rng.integers(0, 255, (2, 2, 2)).astype(np.uint8),
        "e": np.array([True, False]),
        "f": _rand(rng, 4).astype(np.float16),
        # packed int4/int8 codes of the published quantized files
        "g.weight": rng.integers(0, 2**32, (3, 4), dtype=np.uint32),
        "h": rng.integers(0, 2**16, (5,), dtype=np.uint16),
    }
    st.save_file(tensors, tmp_path / "ours.safetensors")
    ref_save(tensors, str(tmp_path / "theirs.safetensors"))
    for path in ("ours.safetensors", "theirs.safetensors"):
        a, b = st.load_file(tmp_path / path), ref_load(str(tmp_path / path))
        assert sorted(a) == sorted(b) == sorted(tensors)
        for name, want in tensors.items():
            assert a[name].dtype == b[name].dtype == want.dtype
            np.testing.assert_array_equal(a[name], want)
            np.testing.assert_array_equal(b[name], want)


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and the JAX package out
    of sys.modules."""
    code = (
        "import importlib, pkgutil, sys, f5_tts_tpu_torch\n"
        "for m in pkgutil.walk_packages(f5_tts_tpu_torch.__path__, 'f5_tts_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'f5_tts_tpu.')) or m == 'f5_tts_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
