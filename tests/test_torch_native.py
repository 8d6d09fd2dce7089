"""The port's native WAV decoder (`ops/native`) and training from a WAV
directory, on the CPU.

The decoder builds with g++ into build/f5_tts_tpu_torch/ and agrees bit for
bit with the JAX package's decoder and with its own batch call on every
format it reads; the Python route agrees bit for bit with the JAX package's
`read_wav`. A malformed file raises ValueError (None in the batch call), a
build error carries the compiler's output, and the route counters say which
decoder read each file. Then both trainers train a tiny model from a WAV
tree through `load_dir` -> `make_training_pipeline`, save and resume, and
both example scripts run their first step.
"""

import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from f5_tts_tpu.audio.io import read_wav as jax_read_wav
from f5_tts_tpu.ops.native import wav_decode as jax_wav_decode
from f5_tts_tpu_torch import F5TTS, CFMConfig, DiTConfig, DurationConfig, DurationPredictor
from f5_tts_tpu_torch.audio.io import read_wav
from f5_tts_tpu_torch.data import libritts as LT
from f5_tts_tpu_torch.data import load_dir, make_training_pipeline
from f5_tts_tpu_torch.ops import native
from f5_tts_tpu_torch.audio.io import WAV_FORMATS, write_wav_format
from f5_tts_tpu_torch.training import DurationTrainer, F5TTSTrainer

REPO = Path(__file__).resolve().parent.parent
CASES = [(fmt, 1) for fmt in WAV_FORMATS] + [("pcm16", 2), ("float32", 2), ("pcm24", 3)]


def write_tree(root, n_clips=8, seed=0):
    rng = np.random.default_rng(seed)
    d = root / "84" / "121123"
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n_clips):
        n = int(rng.uniform(0.4, 2.0) * 24_000)
        write_wav_format(d / f"84_{i}.wav", (0.1 * rng.standard_normal(n)).astype(np.float32), 24_000)
        (d / f"84_{i}.normalized.txt").write_text(f"Sentence number {i} of the tree.")
    return root


@pytest.mark.parametrize("fmt,channels", CASES)
def test_native_decoder_matches_jax_bit_for_bit(tmp_path, fmt, channels):
    rng = np.random.default_rng(channels)
    x = (0.5 * rng.standard_normal((3001, channels) if channels > 1 else 3001)).astype(np.float32)
    path = tmp_path / f"{fmt}.wav"
    write_wav_format(path, x, 24_000, fmt)
    got, sr = native.wav_decode(path)
    ref, ref_sr = jax_wav_decode(str(path))
    assert got.dtype == np.float32 and got.shape == ref.shape == x.shape and sr == ref_sr == 24_000
    np.testing.assert_array_equal(got, ref)
    (batch_got, batch_sr), = native.wav_decode_batch([path], num_threads=2)
    np.testing.assert_array_equal(batch_got, got)
    assert batch_sr == sr
    py, py_sr = read_wav(path)
    py_ref, _ = jax_read_wav(path)
    assert py.dtype == py_ref.dtype == np.float32 and py_sr == sr
    np.testing.assert_array_equal(py, py_ref)
    np.testing.assert_allclose(got, np.clip(x, -1, 1), atol=1.0 / 64)  # the format's precision


def test_batch_decode_keeps_order_and_marks_failures(tmp_path):
    rng = np.random.default_rng(4)
    paths = []
    for i in range(9):
        p = tmp_path / f"x{i}.wav"
        if i in (2, 7):
            p.write_bytes(b"RIFF....WAVEjunk" if i == 2 else b"")
        else:
            write_wav_format(p, (0.1 * rng.standard_normal(500 + i)).astype(np.float32), 24_000,
                             WAV_FORMATS[i % len(WAV_FORMATS)])
        paths.append(p)
    out = native.wav_decode_batch(paths + [tmp_path / "missing.wav"], num_threads=3)
    assert [o is None for o in out] == [i in (2, 7, 9) for i in range(10)]
    for p, o in zip(paths, out):
        if o is not None:
            np.testing.assert_array_equal(o[0], native.wav_decode(p)[0])
            assert o[0].shape == (500 + int(p.stem[1:]),)
    with pytest.raises(ValueError, match="failed to decode"):
        native.wav_decode(paths[2])
    assert native.wav_decode_batch([]) == []


def test_routes_count_the_decoder_that_ran(tmp_path, monkeypatch):
    root = write_tree(tmp_path, n_clips=3)
    (root / "84" / "121123" / "bad.wav").write_bytes(b"not a wav")
    (root / "84" / "121123" / "bad.normalized.txt").write_text("bad")
    samples = LT.scan_samples(root)
    LT.reset_decode_routes()
    decoded = [LT.decode_sample(s) for s in samples]
    assert sum(d is None for d in decoded) == 1
    assert LT.decode_routes() == {"native": 4, "python": 0}

    def unavailable():
        raise ImportError("g++ failed to build libwav_decoder_x.so (exit 1):\nerror: no compiler")

    monkeypatch.setattr(native, "library", unavailable)
    LT.reset_decode_routes()
    with pytest.warns(RuntimeWarning, match="no compiler"):
        fallback = [LT.decode_sample(s) for s in samples]
    assert LT.decode_routes() == {"native": 0, "python": 4}
    for a, b in zip(decoded, fallback):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a["audio"], b["audio"])  # 16-bit: both divide by 32768
            np.testing.assert_array_equal(a["transcript"], b["transcript"])


def test_library_builds_under_build_dir_and_a_build_error_is_visible(tmp_path, monkeypatch):
    lib = native.library()
    path = native.library_path()
    assert path == REPO / "build" / "f5_tts_tpu_torch" / path.name and path.exists()
    assert path.name.startswith("libwav_decoder_") and len(path.stem.split("_")[-1]) == 16
    assert lib is native.library()
    assert not list((REPO / "f5_tts_tpu_torch").rglob("*.so"))

    broken = tmp_path / "wav_decoder.cpp"
    broken.write_text("int f5_wav_decode( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    for _ in range(2):  # the same error again, without a second build
        with pytest.raises(ImportError, match="(?s)g\\+\\+ failed to build libwav_decoder_.*error"):
            native.library()
    assert not list((tmp_path / "build").glob("*.so"))


# ------------------------------------------------------------------ training from a directory

TINY = DiTConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256,
                 text_dim=32, conv_layers=1)
TINY_DUR = DurationConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32, conv_layers=1)


def _pipeline(root, on_device_mel):
    return make_training_pipeline(load_dir(root), batch_size=2, epochs=3, shuffle_buffer=4, num_threads=2,
                                  pad_frame_multiple=64, seed=0, on_device_mel=on_device_mel)


def _params(module) -> dict:
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def test_cfm_trainer_trains_and_resumes_from_a_wav_directory(tmp_path, capsys):
    root = write_tree(tmp_path / "wavs")
    model = F5TTS.init(torch.Generator().manual_seed(0), TINY, device="cpu", cfm_cfg=CFMConfig(duration_bucket=64))
    before = _params(model.dit)
    trainer = F5TTSTrainer(model, num_warmup_steps=1, results_dir=tmp_path / "r", ema_decay=0.99)
    trainer.train(_pipeline(root, True), total_steps=3, save_every=3, sample_every=10**9, log_every=1,
                  on_device_mel=True, grad_accum=2)
    assert trainer.state.step == 3
    for name in ("f5tts_3.safetensors", "f5tts_3.ema.safetensors", "f5tts_3.trainstate.safetensors"):
        assert (tmp_path / "r" / name).exists()
    after = _params(model.dit)
    assert any(not torch.equal(before[k], after[k]) for k in before)
    losses = [float(line.split("loss ")[1].split()[0]) for line in capsys.readouterr().out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(np.isfinite(losses))

    fresh = F5TTS.init(torch.Generator().manual_seed(1), TINY, device="cpu", cfm_cfg=CFMConfig(duration_bucket=64))
    resumed = F5TTSTrainer(fresh, num_warmup_steps=1, results_dir=tmp_path / "r", ema_decay=0.99)
    resumed.train(_pipeline(root, False), total_steps=5, save_every=5, sample_every=10**9, checkpoint="latest")
    assert resumed.state.step == 5 and resumed.state.opt_state["count"] == 5
    assert (tmp_path / "r" / "f5tts_5.safetensors").exists()
    assert "Starting training at step 3" in capsys.readouterr().out


def test_duration_trainer_trains_and_resumes_from_a_wav_directory(tmp_path, capsys):
    root = write_tree(tmp_path / "wavs")
    model = DurationPredictor.init(torch.Generator().manual_seed(0), TINY_DUR, device="cpu")
    before = _params(model)
    trainer = DurationTrainer(model, num_warmup_steps=1, results_dir=tmp_path / "r", ema_decay=0.99)
    trainer.train(_pipeline(root, False), total_steps=2, save_every=2, log_every=1)
    assert trainer.state.step == 2
    assert (tmp_path / "r" / "duration_2.safetensors").exists()
    assert (tmp_path / "r" / "duration_2.ema.safetensors").exists()
    assert any(not torch.equal(before[k], p) for k, p in _params(model).items())

    fresh = DurationPredictor.init(torch.Generator().manual_seed(1), TINY_DUR, device="cpu")
    resumed = DurationTrainer(fresh, num_warmup_steps=1, results_dir=tmp_path / "r")
    resumed.train(_pipeline(root, False), total_steps=3, save_every=3, checkpoint=2)
    assert resumed.state.step == 3 and resumed.state.opt_state["count"] == 3  # the step-2 state restored
    assert (tmp_path / "r" / "duration_3.trainstate.safetensors").exists()
    out = capsys.readouterr().out
    assert "Starting training at step 2" in out and "step 3/3: loss" in out


@pytest.mark.parametrize("example", ["torch_train_libritts_small.py", "torch_train_duration.py"])
def test_example_parses_its_arguments_and_takes_a_first_step(tmp_path, capsys, example):
    root = write_tree(tmp_path / "wavs")
    main = runpy.run_path(str(REPO / "examples" / example), run_name="example")["main"]
    main(["--data-dir", str(root), "--device", "cpu", "--depth", "1", "--total-steps", "1",
          "--results-dir", str(tmp_path / "r")])
    out = capsys.readouterr().out
    assert "Found 8 files" in out and "step 1/1: loss" in out and "Training complete" in out
