"""The PyTorch port's weight-only int4/int8 path against the JAX package, on
the CPU in float32: the dequantizing matmul's plain version (K3's), the
quantize and pack helpers, the quantized snapshot files, the quantized DiT
and the whole sampling slice on a quantized model.

The model is tiny (dim 64, text_dim 64, depth 2, 2 heads x 32) so that its
linears are eligible (input width a multiple of 64); inputs and noise are
made with numpy from a seed. Tolerances: 1e-4 absolute for the matmul on
O(1) outputs and for the DiT forward, 1e-3 for the pipeline mel and wave
(float32 math summed in another order); bit-exact for quantization, packing
and files.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.config import VocosConfig as JaxVocosConfig
from f5_tts_tpu.models import quant as jq
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.dit import dit_forward_precomputed, dit_text_embed, dit_time_mods
from f5_tts_tpu.models.vocos import Vocos as JaxVocos
from f5_tts_tpu.ops.qmatmul import qmatmul as jax_qmatmul
from f5_tts_tpu_torch.config import F5TTS_V1_BASE, CFMConfig, DiTConfig, VocosConfig
from f5_tts_tpu_torch.models import quant as tq
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.convert import convert_dit_state, params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain
from f5_tts_tpu_torch.utils.safetensors import load_file

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
            text_num_embeds=256, text_dim=64, conv_layers=1)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {c: i for i, c in enumerate([""] + [chr(c) for c in range(ord(" "), ord(" ") + 95)])}
MANIFESTS = Path(__file__).parent / "manifests"


def _close(t: torch.Tensor, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _port_params(p: dict) -> tuple[torch.Tensor, ...]:
    """A JAX quantized leaf {q [k, n], scales, biases [k/64, n]} in the
    port's [n, k] layout."""
    return tuple(torch.tensor(np.ascontiguousarray(np.asarray(p[name]).T)) for name in ("q", "scales", "biases"))


# ------------------------------------------------------------------ K3, plain


@pytest.mark.parametrize("n", [100, 256])
@pytest.mark.parametrize("k", [64, 256])
@pytest.mark.parametrize("m", [1, 31, 130])
@pytest.mark.parametrize("bits", [4, 8])
def test_qmatmul_plain_matches_jax(bits, m, k, n):
    """K3's plain version against the JAX package's `quantized_matmul` and,
    where its kernel takes the shape (n % 128 == 0), the Pallas kernel itself
    in interpret mode. Tolerance 1e-4 on O(1) outputs."""
    rng = np.random.default_rng(bits * 1000 + m * 10 + k + n)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    p = jq.quantize_kernel(w, bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    got = qmatmul_plain(torch.tensor(x), *_port_params(p))
    _close(got, jq.quantized_matmul(jnp.asarray(x), p), 1e-4)
    if n % 128 == 0:
        _close(got, jax_qmatmul(jnp.asarray(x), p), 1e-4)
    # with the linear's bias, and through the wrapper (CPU tensors take the plain version)
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), p)) + bias
    _close(qmatmul(torch.tensor(x), *_port_params(p), torch.tensor(bias)), ref, 1e-4)


def test_qmatmul_wrapper_rejects_other_devices():
    q = torch.zeros(8, 64, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        qmatmul(torch.zeros(2, 64, device="meta"), q, q[:, :1].float(), q[:, :1].float())


# ------------------------------------------------------------------ host code


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_and_pack_bit_exact(bits):
    rng = np.random.default_rng(bits)
    kernel = rng.standard_normal((256, 96)).astype(np.float32)
    kernel[64:128, :3] = 0.5  # constant groups: zero range, scale 1e-8
    got, ref = tq.quantize_kernel(kernel, bits), jq.quantize_kernel(kernel, bits)
    for name in ("q", "scales", "biases"):
        assert got[name].dtype == ref[name].dtype
        np.testing.assert_array_equal(got[name], ref[name])
    codes = rng.integers(0, 1 << bits, (48, 128)).astype(np.uint8)
    packed = tq.pack_mlx_uint32(codes, bits)
    np.testing.assert_array_equal(packed, jq.pack_mlx_uint32(codes, bits))
    np.testing.assert_array_equal(tq.unpack_mlx_uint32(packed, bits), jq.unpack_mlx_uint32(packed, bits))
    np.testing.assert_array_equal(tq.unpack_mlx_uint32(packed, bits), codes)
    assert tq.quantizable((128, 7)) and not tq.quantizable((712, 64)) and not tq.quantizable((64, 7, 3))
    # dequantization in the port's [out, in] layout
    p = jq.quantize_kernel(kernel, bits)
    _close(tq.dequantize_kernel(*_port_params(p)).T, jq.dequantize_kernel(p), 0)


# ------------------------------------------------------------------ models


@pytest.fixture(scope="module")
def float_models():
    """The same random tiny float model in both packages."""
    jax_model = JaxF5TTS.init(
        jax.random.key(0), JaxDiTConfig(**TINY), cfm_cfg=JaxCFMConfig(duration_bucket=64),
        vocab_char_map=VOCAB, vocoder=JaxVocos.init(jax.random.key(1), JaxVocosConfig(**VOCOS)).decode,
    )
    rng = np.random.default_rng(0)  # the JAX init leaves GRN gamma/beta at zero
    for blk in jax_model.params["text_embed"]["blocks"]:
        blk["grn"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
                      for k, v in blk["grn"].items()}
    dit = DiT(DiTConfig(**TINY))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_model.params), DiTConfig(**TINY)))
    vocos = Vocos(VocosConfig(**VOCOS))
    vocos.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jax_model._vocoder.__self__.params), VocosConfig(**VOCOS)))
    port = F5TTS(dit, DiTConfig(**TINY), cfm_cfg=CFMConfig(duration_bucket=64),
                 vocab_char_map=VOCAB, vocoder=vocos)
    return jax_model, port


@pytest.fixture(scope="module", params=[4, 8], ids=["int4", "int8"])
def quant_models(float_models, tmp_path_factory, request):
    """Each package's save_pretrained(quantization_bits=b) from the same float
    weights, and the JAX snapshot loaded by both packages."""
    bits = request.param
    jax_model, port = float_models
    root = tmp_path_factory.mktemp(f"q{bits}")
    jax_model.save_pretrained(root / "jax", quantization_bits=bits)
    port.save_pretrained(root / "port", quantization_bits=bits)
    return (bits, root, JaxF5TTS.from_pretrained(str(root / "jax"), quantization_bits=bits),
            F5TTS.from_pretrained(root / "jax", device="cpu", quantization_bits=bits))


def test_quantize_module_matches_quantize_tree(float_models):
    """The port's in-memory quantization of a float DiT equals the JAX
    package's `quantize_tree` moved over, tensor for tensor."""
    jax_model, port = float_models
    for bits in (4, 8):
        dit = tq.quantize_module_(DiT(port.dit_cfg), None)
        dit.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, jq.quantize_tree(jax_model.params, bits)), port.dit_cfg))
        ours = DiT(port.dit_cfg)
        ours.load_state_dict(port.dit.state_dict())
        ours = tq.quantize_module_(ours, bits).state_dict()
        assert sorted(ours) == sorted(dit.state_dict())
        for k, v in dit.state_dict().items():
            assert ours[k].dtype == v.dtype, k
            torch.testing.assert_close(ours[k], v, rtol=0, atol=0)
        n_quant = sum(isinstance(m, tq.QuantizedLinear) for m in dit.modules())
        assert n_quant == 2 + 2 + 2 * 7 + 1 + 1  # time MLP, ConvNeXt, 2 x 7 per block, norm_out, proj_out


def test_quantized_snapshot_files_match_jax(quant_models):
    """The files both packages write are the same tensor for tensor; each
    package loads the other's."""
    from safetensors.numpy import load_file as ref_load

    bits, root, jax_q, port_q = quant_models
    name = f"model_v1_{bits}b.safetensors"
    ours, theirs = load_file(root / "port" / name), ref_load(str(root / "jax" / name))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert ours["transformer.proj_out.weight"].dtype == np.uint32
    from_port = F5TTS.from_pretrained(root / "port", device="cpu", quantization_bits=bits)
    for k, v in port_q.dit.state_dict().items():
        torch.testing.assert_close(from_port.dit.state_dict()[k], v, rtol=0, atol=0)
    back = JaxF5TTS.from_pretrained(str(root / "port"), quantization_bits=bits)
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jax_q.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_quantized_dit_forward_matches_jax(quant_models):
    _, _, jax_q, port_q = quant_models
    rng = np.random.default_rng(2)
    b, n = 2, 40
    x, cond = (rng.standard_normal((b, n, 100)).astype(np.float32) for _ in range(2))
    text = rng.integers(0, 96, (b, 30)).astype(np.int32)
    text[0, 20:] = -1
    mask = np.arange(n)[None, :] < np.array([n, 31])[:, None]
    drop = np.array([False, True])
    p, cfg = jax_q.params, jax_q.dit_cfg
    te = dit_text_embed(p, cfg, jnp.asarray(text), n)
    mods = jax.tree.map(lambda a: a[0], dit_time_mods(p, cfg, jnp.asarray([0.3], jnp.float32)))
    ref = dit_forward_precomputed(p, cfg, jnp.asarray(x), jnp.asarray(cond), te, None,
                                  drop_audio_cond=jnp.asarray(drop), mask=jnp.asarray(mask), time_mods=mods)
    tte = port_q.dit.embed_text(torch.tensor(text), n)
    _close(tte, te, 1e-4)
    tmods = {k: v[0] for k, v in port_q.dit.time_mods(torch.tensor([0.3])).items()}
    got = port_q.dit(torch.tensor(x), torch.tensor(cond), tte, tmods, drop_audio_cond=torch.tensor(drop),
                     mask=torch.tensor(mask))
    _close(got, ref, 1e-4)


def test_quantized_sample_matches_jax(quant_models):
    """The whole slice on the quantized model: reference wave -> mel -> text
    -> 4-step Euler ODE with CFG -> composite -> Vocos, the same y0 on both
    sides. Tolerance 1e-3 on the trajectory and the wave."""
    _, _, jax_q, port_q = quant_models
    sr = 24_000
    rng = np.random.default_rng(5)
    wave = (0.1 * np.sin(2 * np.pi * 220 * np.arange(sr // 2) / sr)
            + 0.01 * rng.standard_normal(sr // 2)).astype(np.float32)
    y0 = rng.standard_normal((1, 150, 100)).astype(np.float32)
    kw = dict(duration=150, steps=4, method="euler", cfg_strength=2.0, sway_sampling_coef=-1.0)
    ref_wave, ref_traj = jax_q.sample(jnp.asarray(wave)[None], ["hello there"], y0=jnp.asarray(y0), **kw)
    got_wave, got_traj = port_q.sample(wave[None], ["hello there"], y0=y0, **kw)
    assert got_wave.shape == ref_wave.shape == ((150 - 1) * 256,)
    _close(got_traj, ref_traj, 1e-3)
    _close(got_wave, ref_wave, 1e-3)


def test_inference_dit_rebuilds_after_buffer_swap():
    """The bf16 copy is keyed on parameters and buffers: changing a quantized
    linear's scales in place, or replacing its codes, rebuilds it."""
    cfg = DiTConfig(**TINY).replace(compute_dtype="bfloat16")
    torch.manual_seed(0)
    model = F5TTS(tq.quantize_module_(DiT(cfg), 8), cfg)
    first = model._inference_dit()
    assert model._inference_dit() is first
    assert first.proj_out.scales.dtype == torch.bfloat16 and first.proj_out.q.dtype == torch.int8
    model.dit.proj_out.scales.mul_(2)
    second = model._inference_dit()
    assert second is not first
    torch.testing.assert_close(second.proj_out.scales, model.dit.proj_out.scales.to(torch.bfloat16))
    model.dit.proj_out.q = torch.zeros_like(model.dit.proj_out.q)
    third = model._inference_dit()
    assert third is not second and not third.proj_out.q.any()


def test_quantized_loader_rejects_unconsumed_and_missing_keys(quant_models):
    bits, root, _, port_q = quant_models
    raw = load_file(root / "port" / f"model_v1_{bits}b.safetensors")
    with pytest.raises(ValueError, match="unconsumed"):
        convert_dit_state({**raw, "transformer.extra.weight": np.zeros(1)}, port_q.dit_cfg, bits)
    with pytest.raises(ValueError, match="quantization_bits"):
        convert_dit_state(raw, port_q.dit_cfg)
    raw.pop("transformer.proj_out.scales")
    with pytest.raises((KeyError, ValueError), match="proj_out"):
        convert_dit_state(raw, port_q.dit_cfg, bits)


# ------------------------------------------------------------------ manifests


@pytest.mark.parametrize("bits", [4, 8])
def test_published_quantized_manifest_loads(bits):
    """A zero-filled dict with the names, shapes and dtypes of the published
    model_v1_{bits}b.safetensors converts at the base config's full width,
    every key consumed, into the quantized DiT's state dict."""
    from manifests.gen_manifests import parse

    manifest = parse((MANIFESTS / f"model_v1_{bits}b.txt").read_text())
    dtypes = {"f4": np.float32, "u4": np.uint32}
    raw = {k: np.zeros(shape, dtypes[kind]) for k, (shape, kind) in manifest.items()}
    cfg = F5TTS_V1_BASE.replace(text_num_embeds=2545)
    state = convert_dit_state(raw, cfg, quant_bits=bits)
    with torch.device("meta"):
        ref = tq.quantize_module_(DiT(cfg), None).state_dict()
    assert sorted(state) == sorted(ref)
    for k, v in state.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
    assert state["transformer_blocks.0.attn.to_q.q"].shape == (1024, 1024)


def test_quant_quality_records_the_distortion(capsys):
    """The port's distortion record on the CPU: one finite JSON line per
    weight-only mode, int8's distortion below int4's."""
    import json

    from f5_tts_tpu_torch.tools import quant_quality

    lines = quant_quality.main(["--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == lines and [line["q"] for line in lines] == [8, 4]
    for line in lines:
        assert all(np.isfinite(line[k]) and line[k] > 0 for k in ("mel_rel_mae", "mel_rel_rmse"))
    assert lines[0]["mel_rel_mae"] < lines[1]["mel_rel_mae"] and lines[0]["mel_rel_rmse"] < lines[1]["mel_rel_rmse"]
