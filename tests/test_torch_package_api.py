"""The port's package exports and the functions behind them, against the
JAX package on the CPU: each `__all__` holds the JAX one but for the
deliberate omissions listed here; `frame_signal`, `stft`, `MelSpec`,
`log_mel_spectrogram(padding=)` and `mel_filters`' Slaney options within
1e-5 (relative, over each output's largest magnitude), `pad_to_length` and
`pad_sequence` exactly; `load_libritts_r` on an archive already on disk
scanning what the JAX function scans, and never downloading.
"""

import gzip
import importlib
import shutil
import tarfile
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.audio import mel as jmel
from f5_tts_tpu.config import AudioConfig as JaxAudioConfig
from f5_tts_tpu.data import libritts as jlib
from f5_tts_tpu.utils import masks as jmasks
from f5_tts_tpu_torch.audio import mel
from f5_tts_tpu_torch.audio.io import write_wav_format
from f5_tts_tpu_torch.config import AudioConfig
from f5_tts_tpu_torch.data import libritts as lib
from f5_tts_tpu_torch.utils import masks

# package -> {JAX name the port leaves out: why}
OMITTED = {
    "parallel": {
        "shard_params": "the port holds no parameter tree to place: a model's shards are per-slot modules "
                        "(shard_model_for_inference, models/shard.py shard_module), a training state's pieces "
                        "come from shard_state",
    },
}
TOL = 1e-5


@pytest.mark.parametrize("package", ["", ".audio", ".utils", ".data", ".parallel", ".training"])
def test_port_exports_the_jax_names(package):
    """Each port `__all__` holds the JAX package's, apart from the listed
    omissions, and each name it lists resolves."""
    jax_all = set(importlib.import_module("f5_tts_tpu" + package).__all__)
    port = importlib.import_module("f5_tts_tpu_torch" + package)
    omitted = OMITTED.get(package.lstrip("."), {})
    assert set(omitted) <= jax_all
    assert not jax_all - set(port.__all__) - set(omitted)
    assert not set(omitted) & set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _signal(n=5000, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("frame_length, hop", [(256, 64), (1024, 256), (100, 37)])
def test_frame_signal_matches_jax(frame_length, hop):
    x = _signal()
    got = mel.frame_signal(torch.tensor(x), frame_length, hop)
    ref = jmel.frame_signal(jnp.asarray(x), frame_length, hop)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kw", [{}, dict(nperseg=1024, noverlap=256), dict(nperseg=200, noverlap=50, nfft=200)],
                         ids=["defaults", "mel", "odd"])
def test_stft_matches_jax(kw):
    x = _signal()
    window = mel.hanning(kw.get("nperseg", 256))
    got = mel.stft(torch.tensor(x), torch.tensor(window), **kw)
    ref = jmel.stft(jnp.asarray(x), jnp.asarray(window), **kw)
    assert got.dtype == torch.complex64
    _close(got.numpy(), np.asarray(ref))


def test_stft_zero_pads_windowed_frames_to_nfft():
    """nfft > nperseg: each windowed frame zero-padded to nfft, as the JAX
    function's framing, window and rfft give it. The JAX function itself
    pads before it windows, and its product then fails to broadcast."""
    x = _signal()
    window = mel.hanning(256)
    got = mel.stft(torch.tensor(x), torch.tensor(window), nperseg=256, noverlap=64, nfft=512)
    frames = jmel.frame_signal(jnp.pad(jnp.asarray(x), (128, 128)), 256, 64) * jnp.asarray(window)[None]
    ref = jnp.fft.rfft(jnp.pad(frames, ((0, 0), (0, 256))))
    assert got.shape == (ref.shape[0], 257)
    _close(got.numpy(), np.asarray(ref))
    with pytest.raises(TypeError, match="broadcast"):
        jmel.stft(jnp.asarray(x), jnp.asarray(window), nperseg=256, noverlap=64, nfft=512)


@pytest.mark.parametrize("padding", [0, 300])
def test_mel_spec_and_padding_match_jax(padding):
    """`MelSpec.from_config` and `log_mel_spectrogram(padding=)` on a batch,
    a non-default config too; padding 0 leaves the model path's output as
    it was."""
    audio = np.stack([_signal(6000, 1), _signal(6000, 2)])
    got = mel.log_mel_spectrogram(torch.tensor(audio), padding=padding)
    _close(got.numpy(), np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), padding=padding)))
    if not padding:
        assert torch.equal(got, mel.log_mel_spectrogram(torch.tensor(audio)))
    cfg = dict(sample_rate=22_050, n_fft=512, hop_length=128, n_mels=80)
    spec = mel.MelSpec.from_config(AudioConfig(**cfg))
    assert (spec.sample_rate, spec.n_fft, spec.hop_length, spec.n_mels) == tuple(cfg.values())
    _close(spec(torch.tensor(audio)).numpy(), np.asarray(jmel.MelSpec.from_config(JaxAudioConfig(**cfg))(
        jnp.asarray(audio))))
    _close(mel.MelSpec()(torch.tensor(audio[0])).numpy(), np.asarray(jmel.MelSpec()(jnp.asarray(audio[0]))))


@pytest.mark.parametrize("norm, scale", [(None, "htk"), ("slaney", "slaney"), (None, "slaney"), ("slaney", "htk")])
def test_mel_filters_match_jax(norm, scale):
    got = mel.mel_filters(24_000, 1024, 100, norm=norm, mel_scale=scale)
    _close(got, jmel.mel_filters(24_000, 1024, 100, norm=norm, mel_scale=scale))


def test_pad_to_length_and_pad_sequence_match_jax():
    rng = np.random.default_rng(4)
    for x in (rng.integers(0, 9, (2, 5)).astype(np.int32), rng.standard_normal((3, 2, 6)).astype(np.float32)):
        for length, value in ((9, 0), (9, -1), (3, 0), (x.shape[-1], 7)):
            got = masks.pad_to_length(torch.tensor(x), length, value)
            ref = np.asarray(jmasks.pad_to_length(jnp.asarray(x), length, value))
            assert got.numpy().dtype == ref.dtype
            np.testing.assert_array_equal(got.numpy(), ref)
    seqs = [rng.integers(0, 9, n).astype(np.int32) for n in (3, 7, 1)]
    for value in (0, -1):
        got = masks.pad_sequence([torch.tensor(s) for s in seqs], padding_value=value)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jmasks.pad_sequence(
            [jnp.asarray(s) for s in seqs], padding_value=value)))


# ------------------------------------------------------------- the LibriTTS-R archive on disk

def _write_split(root, split="dev-clean"):
    """A tiny LibriTTS_R/<split> tree: 16-bit 24 kHz clips of 0.2 to 1.6 s
    with transcripts (one over the 1.0 s limit the tests scan with), and a
    clip without one."""
    rng = np.random.default_rng(5)
    for speaker, chapter, secs in (("19", "198", (0.2, 0.5, 1.6)), ("84", "121", (0.4, 0.9))):
        d = root / "LibriTTS_R" / split / speaker / chapter
        d.mkdir(parents=True)
        for i, s in enumerate(secs):
            stem = f"{speaker}_{chapter}_{i:06d}"
            write_wav_format(d / f"{stem}.wav", (0.1 * rng.standard_normal(int(s * 24_000))).astype(np.float32),
                             24_000)
            (d / f"{stem}.normalized.txt").write_text(f"Clip {i} of speaker {speaker}.")
        write_wav_format(d / "untranscribed.wav", np.zeros(2400, np.float32), 24_000)
    return root / "LibriTTS_R" / split


def _archive(tree_root, dst, name, compress=True):
    """Tar `tree_root/LibriTTS_R` as `dst/name`.tar, gzipped to .tar.gz."""
    dst.mkdir(parents=True, exist_ok=True)
    tar = dst / f"{name}.tar"
    with tarfile.open(tar, "w") as t:
        t.add(tree_root / "LibriTTS_R", arcname="LibriTTS_R")
    if compress:
        with open(tar, "rb") as fin, gzip.open(f"{tar}.gz", "wb") as fout:
            shutil.copyfileobj(fin, fout)
        tar.unlink()
    return tar


def _relative(stream, base):
    return [(s["file"].relative_to(base), s["transcript_file"].relative_to(base)) for s in stream]


@pytest.fixture
def no_download(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError(f"a download was attempted: {args}")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def test_load_libritts_r_scans_a_gzipped_archive_as_jax_does(tmp_path, no_download):
    """The split's .tar.gz under root: both packages gunzip it, remove the
    .gz, extract and scan the same samples, which are `load_dir`'s on the
    tree that was archived."""
    split_dir = _write_split(tmp_path / "tree")
    _archive(tmp_path / "tree", tmp_path / "port", "dev_clean")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    stream, path = lib.load_libritts_r(tmp_path / "port", "dev-clean", max_duration=1.0)
    jstream, jpath = jlib.load_libritts_r(tmp_path / "jax", "dev-clean", max_duration=1.0)
    assert path == tmp_path / "port" / "LibriTTS_R" / "dev-clean" and jpath.name == "dev-clean"
    got = _relative(stream, path)
    assert got == _relative(jstream, jpath) == _relative(lib.load_dir(split_dir, max_duration=1.0), split_dir)
    assert len(got) == 4
    for root in (tmp_path / "port", tmp_path / "jax"):
        assert (root / "dev_clean.tar").is_file() and not (root / "dev_clean.tar.gz").exists()


def test_a_present_tar_is_reused(tmp_path, no_download):
    """A .tar already under root is used as it is: a .tar.gz beside it is
    not opened (here it is not even gzip), and both packages agree."""
    _write_split(tmp_path / "tree", "test-other")
    for side in ("port", "jax"):
        _archive(tmp_path / "tree", tmp_path / side, "test_other", compress=False)
        (tmp_path / side / "test_other.tar.gz").write_bytes(b"not a gzip stream")
    assert lib.load_libritts_r_tarfile(tmp_path / "port", "test-other") == tmp_path / "port" / "test_other.tar"
    stream, path = lib.load_libritts_r(tmp_path / "port", "test-other")
    jstream, jpath = jlib.load_libritts_r(tmp_path / "jax", "test-other")
    assert _relative(stream, path) == _relative(jstream, jpath) and len(_relative(stream, path)) == 5
    assert (tmp_path / "port" / "test_other.tar.gz").read_bytes() == b"not a gzip stream"


def test_unknown_split_and_missing_archive_raise(tmp_path, no_download, monkeypatch):
    """An unknown split raises the JAX package's ValueError; a split whose
    archive is not under root raises ValueError naming the file and saying
    that downloading is not ported, without a download; the splits and the
    default cache (F5_TTS_CACHE) are the JAX package's."""
    with pytest.raises(ValueError) as port_err:
        lib.load_libritts_r_tarfile(tmp_path, "dev-dirty")
    with pytest.raises(ValueError) as jax_err:
        jlib.load_libritts_r_tarfile(tmp_path, "dev-dirty")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match=r"dev_clean\.tar\.gz.*not ported"):
        lib.load_libritts_r(tmp_path, "dev-clean")
    assert lib.SPLITS == jlib.SPLITS and lib.CACHE_DIR == jlib.CACHE_DIR
    monkeypatch.setattr(lib, "CACHE_DIR", tmp_path / "cache")
    with pytest.raises(ValueError, match=str(tmp_path / "cache" / "libritts_r" / "dev_clean.tar.gz")):
        lib.load_libritts_r_tarfile(split="dev-clean")
