"""The port's CLI layer (`f5_tts_tpu_torch/generate.py`, `audio/resample.py`,
the bundled reference clip) against the JAX package's, on the CPU.

Both packages load one tiny snapshot that the JAX package writes (the DiT
of `tests/test_serve.py`: dim 64, depth 2, 2 heads x 32, text_dim 32; Vocos
at dim 64; 64-frame buckets; byte tokens). Their noise comes from different
PRNGs, so the orchestration is held to the JAX function's through the
calls each makes to `F5TTS.sample`: the same groups, text ids, durations,
sampler options and waves' lengths, and reference mels within 1e-4.
"""

import argparse
from importlib import resources

import jax
import numpy as np
import pytest
import torch

from f5_tts_tpu import generate as jgen
from f5_tts_tpu.audio.resample import resample as jax_resample
from f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.config import VocosConfig as JaxVocosConfig
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.vocos import Vocos as JaxVocos
from f5_tts_tpu_torch import generate as tgen
from f5_tts_tpu_torch.audio.io import read_wav, write_wav
from f5_tts_tpu_torch.audio.resample import _resample_fft, resample
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.quant import W8A8Linear
from f5_tts_tpu_torch.parallel.mesh import create_mesh

DIT = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
           text_num_embeds=256, text_dim=32, conv_layers=1)
VOCOS = dict(dim=64, intermediate_dim=128, num_layers=2)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    path = tmp_path_factory.mktemp("snap")
    JaxF5TTS.init(
        jax.random.key(0), JaxDiTConfig(**DIT, use_flash_attention=False), cfm_cfg=JaxCFMConfig(duration_bucket=64),
        vocoder=JaxVocos.init(jax.random.key(1), JaxVocosConfig(**VOCOS)).decode,
    ).save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def model(snapshot):
    return F5TTS.from_pretrained(snapshot, device="cpu")


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    """A quiet 0.5 s tone (RMS below the 0.1 target, so it is normalised)
    with a little noise, which keeps every mel bin above the log floor."""
    rng = np.random.default_rng(0)
    t = np.arange(12_000) / 24_000
    wave = (0.05 * np.sin(2 * np.pi * 220 * t) + 0.005 * rng.standard_normal(t.size)).astype(np.float32)
    path = tmp_path_factory.mktemp("ref") / "ref.wav"
    write_wav(path, wave, 24_000)
    return str(path)


TEXTS = ["Hello there. How are you? Fine; thanks: bye!", "no punctuation", "First. Second. and then some",
         "", "   ", "Wait... what?! Really.", "你好。世界！", "a:b;c"]


@pytest.mark.parametrize("text", TEXTS)
def test_split_sentences_matches_jax(text):
    assert tgen.split_sentences(text) == jgen.split_sentences(text)


@pytest.mark.parametrize("ref_text, gen_text, speed", [
    ("hello there friend", "hello there friend", 1.0), ("hi", "a much longer generation text here", 1.0),
    ("参考文本，好的。", "生成的文本！还有：更多？", 0.7), ("some reference", "short", 1.5)])
def test_estimated_duration_matches_jax(ref_text, gen_text, speed):
    ref = np.zeros(37_000, dtype=np.float32)
    for kw in ({}, {"hop_length": 512, "frames_per_second": 24_000 / 512}):
        assert tgen.estimated_duration(ref, ref_text, gen_text, speed, **kw) == \
            jgen.estimated_duration(ref, ref_text, gen_text, speed, **kw)


def test_bundled_clip_matches_jax_copy():
    ours = resources.files("f5_tts_tpu_torch").joinpath("assets/test_en_1_ref_short.wav")
    theirs = resources.files("f5_tts_tpu").joinpath("assets/test_en_1_ref_short.wav")
    assert ours.read_bytes() == theirs.read_bytes()
    audio, text = tgen._load_ref_audio(None, None)
    ref_audio, ref_text = jgen._load_ref_audio(None, None)
    np.testing.assert_array_equal(audio, ref_audio)
    assert audio.shape == (127_987,) and text == ref_text == tgen.DEFAULT_REF_TEXT


@pytest.mark.parametrize("fn", [resample, _resample_fft], ids=["polyphase", "fft"])
def test_resample_matches_jax(fn):
    rng = np.random.default_rng(3)
    audio = (0.3 * np.sin(2 * np.pi * 330 * np.arange(16_000) / 16_000)
             + 0.05 * rng.standard_normal(16_000)).astype(np.float32)
    if fn is resample:
        ref = jax_resample(audio, 16_000, 24_000)
    else:
        from f5_tts_tpu.audio.resample import _resample_fft as jax_fft

        ref = jax_fft(audio, 16_000, 24_000)
    got = fn(audio, 16_000, 24_000)
    assert got.dtype == np.float32 and got.shape == ref.shape == (24_000,)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert resample(audio, 24_000, 24_000) is audio


def _options(parser: argparse.ArgumentParser) -> dict:
    return {tuple(a.option_strings): (a.dest, a.default, a.type, a.choices, type(a).__name__)
            for a in parser._actions}


def test_parser_matches_jax_but_device():
    ours, theirs = _options(tgen.build_parser()), _options(jgen.build_parser())
    assert ours.pop(("--device",)) == ("device", "cuda", str, None, "_StoreAction")
    assert ours == theirs
    args = tgen.build_parser().parse_args(
        ["--text", "hi", "--steps", "4", "--method", "euler", "--cfg", "1.5", "--sway-coef", "-0.8",
         "--speed", "1.2", "--seed", "3", "--q", "8", "--resample-ref", "--device", "cpu"])
    assert (args.text, args.steps, args.q, args.method, args.cfg, args.device) == ("hi", 4, 8, "euler", 1.5, "cpu")
    assert args.resample_ref is True


def test_generate_rejects_wrong_sample_rate(model, tmp_path):
    ref = tmp_path / "ref16k.wav"
    write_wav(ref, np.zeros(16_000, dtype=np.float32), 16_000)
    with pytest.raises(ValueError, match="24000 Hz"):
        tgen.generate("hi", duration=1.0, ref_audio_path=str(ref), ref_audio_text="x", model=model, play=False)


def test_generate_resample_ref_accepts_16k(model, tmp_path):
    ref = tmp_path / "ref16k.wav"
    write_wav(ref, (0.2 * np.sin(2 * np.pi * 220 * np.arange(16_000) / 16_000)).astype(np.float32), 16_000)
    out = tmp_path / "out.wav"
    wave = tgen.generate("hi", duration=2.0, ref_audio_path=str(ref), ref_audio_text="a tone", model=model,
                         play=False, steps=2, method="euler", seed=0, output_path=str(out), resample_ref=True)
    # 2 s in all (187 frames) less the last frame, cut at the 1 s resampled reference's 24,000 samples
    assert wave.shape == ((187 - 1) * 256 - 24_000,)
    got, sr = read_wav(out)
    assert sr == 24_000 and got.shape == wave.shape


def test_generate_single_sentence(model, ref_path, tmp_path):
    out = tmp_path / "out.wav"
    wave = tgen.generate("Hello world", duration=2.0, ref_audio_path=ref_path, ref_audio_text="a tone",
                         steps=2, method="euler", seed=0, output_path=str(out), model=model, play=False,
                         cfg_interval=(0.0, 0.5))
    assert wave.dtype == np.float32 and np.isfinite(wave).all()
    assert wave.shape == ((187 - 1) * 256 - 12_000,)  # the sample trimmed at the reference's raw length
    got, sr = read_wav(out)
    assert sr == 24_000 and got.shape == wave.shape


def test_refusals(model, ref_path, monkeypatch):
    with pytest.raises(ValueError, match="cannot be combined"):
        tgen.generate("hi", duration=1.0, quantization_bits=8, int8_compute=True)
    # int8_compute samples W8A8: the model that samples has the flag and its DiT runs W8A8 linears
    seen = []
    real = F5TTS.sample

    def sample(self, *args, **kw):
        seen.append((self.dit_cfg.int8_compute, type(self._inference_dit().transformer_blocks[0].attn.to_q)))
        return real(self, *args, **kw)

    monkeypatch.setattr(F5TTS, "sample", sample)
    wave = tgen.generate("hi", duration=1.0, int8_compute=True, model=model, play=False, ref_audio_path=ref_path,
                         ref_audio_text="a tone", steps=2, method="euler", seed=0)
    assert np.isfinite(wave).all() and wave.shape == ((93 - 1) * 256 - 12_000,)
    assert seen == [(True, W8A8Linear)]
    assert not model.dit_cfg.int8_compute
    # a mesh (two slots on the CPU) samples what the model samples alone, on a copy: the caller's model stays
    # unsharded
    monkeypatch.undo()
    kw = dict(duration=1.0, model=model, play=False, ref_audio_path=ref_path, ref_audio_text="a tone", steps=2,
              method="euler", seed=0)
    sharded = tgen.generate("hi", mesh=create_mesh(data=2, devices=["cpu"] * 2), **kw)
    np.testing.assert_allclose(sharded, tgen.generate("hi", **kw), atol=1e-5)
    assert model._mesh is None
    with pytest.raises(ValueError, match="not ported"):
        tgen.generate("hi", duration=1.0, model_name="lucasnewman/f5-tts-mlx", play=False)


@pytest.mark.parametrize("argv, error", [
    (["--mesh-data", "2"], ValueError),  # a mesh of the one CPU device: "mesh 2x1x1 needs 2 devices, have 1"
    (["--mesh-model", "2"], ValueError), (["--q", "8", "--w8a8"], ValueError),
    (["--model", "no/such/dir"], ValueError), (["--model", "no/such/dir", "--w8a8"], ValueError)])
def test_cli_refusals(argv, error):
    with pytest.raises(error) as caught:
        tgen.main(argv + ["--text", "hi", "--device", "cpu"])
    if argv[0].startswith("--mesh"):  # refused by create_mesh, before the model loads
        assert str(caught.value) == f"mesh {'2x1x1' if argv[0] == '--mesh-data' else '1x1x2'} needs 2 devices, have 1"


def test_cli_w8a8_samples_int8_compute(snapshot, ref_path, tmp_path, monkeypatch):
    """--w8a8 loads the float snapshot and samples with int8_compute: its
    DiT blocks run W8A8 linears."""
    flags = []
    real = F5TTS.sample

    def sample(self, *args, **kw):
        flags.append(self.dit_cfg.int8_compute and all(
            isinstance(blk.ff.ff[2], W8A8Linear) for blk in self._inference_dit().transformer_blocks))
        return real(self, *args, **kw)

    monkeypatch.setattr(F5TTS, "sample", sample)
    out = tmp_path / "w8a8.wav"
    tgen.main(["--model", snapshot, "--text", "Hello there.", "--ref-audio", ref_path, "--ref-text", "a tone",
               "--output", str(out), "--steps", "2", "--method", "euler", "--seed", "0", "--device", "cpu",
               "--duration", "1.5", "--w8a8"])
    got, sr = read_wav(out)
    assert flags == [True] and sr == 24_000 and got.ndim == 1 and got.shape[0] > 0 and np.isfinite(got).all()


def test_cli_writes_the_batched_wave(snapshot, ref_path, tmp_path):
    out = tmp_path / "cli.wav"
    tgen.main(["--model", snapshot, "--text", "Hi. Hello there.", "--ref-audio", ref_path, "--ref-text", "a tone",
               "--output", str(out), "--steps", "2", "--method", "euler", "--seed", "0", "--device", "cpu"])
    got, sr = read_wav(out)
    assert sr == 24_000 and got.ndim == 1 and got.shape[0] > 0


def test_generate_does_not_mutate_caller_model(model, ref_path):
    before = {k: v.clone() for k, v in model.dit.state_dict().items()}
    attrs = (model.dit_cfg, model.cfm_cfg, model.audio_cfg, model.vocoder, model.duration_predictor, model.device)
    tgen.generate("Hello world", duration=1.5, ref_audio_path=ref_path, ref_audio_text="a tone", model=model,
                  play=False, int8_compute=True, steps=2, method="euler", seed=0)
    tgen.generate("Hello world. Again!", ref_audio_path=ref_path, ref_audio_text="a tone", steps=2,
                  method="euler", seed=0, model=model, play=False, estimate_duration=True)
    assert (model.dit_cfg, model.cfm_cfg, model.audio_cfg, model.vocoder, model.duration_predictor,
            model.device) == attrs
    assert not model.dit_cfg.int8_compute
    after = model.dit.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def _recorder(calls, real):
    def sample(self, cond, text=None, duration=None, **kw):
        wave, traj = real(self, cond, text=text, duration=duration, **kw)
        calls.append(dict(cond=np.asarray(cond, np.float32), text=np.asarray(text), duration=np.asarray(duration),
                          cfg_interval=kw["cfg_interval"], method=kw["method"], steps=kw["steps"],
                          wave_shape=tuple(np.asarray(wave).shape)))
        return wave, traj
    return sample


def test_orchestration_matches_jax(snapshot, ref_path, monkeypatch):
    """Three sentences of different lengths, durations by the heuristic (the
    snapshot has no predictor): two share a 64-frame bucket, one does not.
    The calls to `sample` agree across packages, and so do the waves'
    lengths and the pieces cut from them."""
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(JaxF5TTS, "sample", _recorder(calls["jax"], JaxF5TTS.sample))
    monkeypatch.setattr(F5TTS, "sample", _recorder(calls["torch"], F5TTS.sample))
    kw = dict(ref_audio_path=ref_path, ref_audio_text="a tone", steps=2, method="euler", seed=0, play=False,
              cfg_interval=(0.0, 0.5), model_name=snapshot)
    text = "Hi. Hello there, friend. Yes."
    ref_wave = jgen.generate(text, **kw)
    wave = tgen.generate(text, device="cpu", **kw)
    assert wave.shape == ref_wave.shape and np.isfinite(wave).all()
    jc, tc = calls["jax"], calls["torch"]
    assert len(jc) == len(tc) == 2
    assert [len(c["duration"]) for c in tc] == [2, 1]  # "Hi." and "Yes." share a bucket
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(t["text"], j["text"])
        np.testing.assert_array_equal(t["duration"], j["duration"])
        assert (t["cfg_interval"], t["method"], t["steps"], t["wave_shape"]) == \
            (j["cfg_interval"], j["method"], j["steps"], j["wave_shape"])
        assert t["cond"].shape == j["cond"].shape
        np.testing.assert_allclose(t["cond"], j["cond"], atol=1e-4, rtol=0)
