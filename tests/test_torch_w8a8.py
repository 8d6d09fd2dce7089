"""W8A8 int8 compute (`DiTConfig.int8_compute`) in the PyTorch port against
the JAX package, on the CPU.

The W8A8 linear's plain versions (ops/w8a8.py) against `_w8a8_matmul` and
the JAX linear that adds the bias after it: the weight codes and scales,
the activation codes and scales, and the int32 accumulators exactly equal,
and the outputs equal to the bit, in float32 and bf16 (no ulp was needed:
XLA's CPU fusion rounds where the expression does). Then the swap of the
DiT blocks' linears (`w8a8_blocks_`), one DiT forward and the whole
sampling slice with the JAX parameters moved over by `params_from_jax`
and the same `y0`. The model is tiny (dim 64, depth 2, 2 heads x 32,
text_dim 64, 64-frame buckets).

Tolerances. Quantization is not continuous: where the two packages'
float32 activations differ by an ulp next to a rounding boundary, a code
moves by one and that output by sx * scale, and later layers and ODE steps
carry it on. So the forward is held within 1e-3 (measured 4.7e-4; the
float forward's test holds 1e-4) and the sampled mel within 5e-3
(measured 2.5e-3 Euler, 2.0e-3 RK4; the float pipeline's 1e-3 is missed by
these flips: the port against itself moves 1.7e-3 when y0 moves by one
ulp). The wave keeps the float pipeline's 1e-3 (measured 5.9e-5). Each
also holds the L2 distance to the JAX W8A8 result under half the distance
between the JAX W8A8 and float results (measured 0.30 and 0.37 of it in
the sample), so the checks tell W8A8 from float.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.config import VocosConfig as JaxVocosConfig
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.dit import dit_forward_precomputed, dit_text_embed, dit_time_mods
from f5_tts_tpu.models.quant import w8a8_blocks, w8a8_from_kernel
from f5_tts_tpu.models.vocos import Vocos as JaxVocos
from f5_tts_tpu.utils.modules import linear as jax_linear
from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, VocosConfig
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.quant import (
    QuantizedLinear,
    W8A8_TARGETS,
    W8A8Linear,
    quantize_module_,
    w8a8_blocks_,
    w8a8_from_weight,
)
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.ops.w8a8 import (
    int8_product_plain,
    quantize_rows,
    quantize_rows_plain,
    rescale_bias,
    w8a8_linear,
    w8a8_linear_plain,
)
from f5_tts_tpu_torch.utils.modules import apply_linear

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
            text_num_embeds=256, text_dim=64, conv_layers=1)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {c: i for i, c in enumerate([""] + [chr(c) for c in range(ord(" "), ord(" ") + 95)])}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# (batch, tokens, k, n): a few tokens, a ragged m, the DiT's widths
SHAPES = [(1, 3, 64, 24), (2, 37, 256, 128), (1, 300, 1024, 512), (2, 50, 2048, 1024)]


def _inputs(shape, seed):
    b, m, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, m, k)).astype(np.float32)
    x[0, 0, :6] = [127.0, 0.5, 1.5, -2.5, 63.5, -127.0]  # codes exactly on .5: half to even
    w = (rng.uniform(-1, 1, (k, n)) / np.sqrt(k)).astype(np.float32)  # JAX's [in, out] kernel
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, w, bias


def _jax_codes(x):
    """The activation codes and scales of `_w8a8_matmul`, in its jnp expression."""
    xf = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) * (1.0 / 127.0)
    return jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8), sx[..., 0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a8_from_weight_matches_jax(shape, dtype):
    """The weight's codes and per-output scales, from the weight in the
    compute dtype, as the JAX package quantizes after its cast."""
    tdt, jdt = DTYPES[dtype]
    _, w, _ = _inputs(shape, 0)
    ref = w8a8_from_kernel(jnp.asarray(w).astype(jdt))
    w8, scale = w8a8_from_weight(torch.tensor(w.T.copy()).to(tdt))
    assert w8.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(w8.numpy(), np.asarray(ref["w8"]).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref["w8_scale"]))


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a8_linear_plain_matches_jax(shape, dtype, with_bias):
    """Codes, activation scales and int32 accumulators exactly equal; the
    output (the bias added in the activations' dtype) equal to the bit."""
    tdt, jdt = DTYPES[dtype]
    x, w, bias = _inputs(shape, 1)
    leaf = w8a8_from_kernel(jnp.asarray(w).astype(jdt))
    jx = jnp.asarray(x).astype(jdt)
    if with_bias:
        leaf["bias"] = jnp.asarray(bias).astype(jdt)
    ref = jax_linear(leaf, jx)
    jq, jsx = _jax_codes(jx)
    jacc = jax.lax.dot_general(jq, leaf["w8"], (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32)

    w8, scale = w8a8_from_weight(torch.tensor(w.T.copy()).to(tdt))
    tx = torch.tensor(x).to(tdt)
    tb = torch.tensor(bias).to(tdt) if with_bias else None
    q, sx = quantize_rows_plain(tx.reshape(-1, tx.shape[-1]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).reshape(q.shape))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx).reshape(-1))
    acc = int8_product_plain(q, w8)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc).reshape(acc.shape))
    np.testing.assert_array_equal(torch.ops.aten._int_mm(q, w8.t()).numpy(), acc.numpy())
    got = w8a8_linear_plain(tx, w8, scale, tb)
    assert got.dtype == tdt and got.shape == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_w8a8_linear_module_runs_the_plain_version_on_the_cpu(dtype):
    """`W8A8Linear.from_linear` of a linear held in the compute dtype, through
    `apply_linear`, is the JAX W8A8 leaf; the wrappers run the plain
    versions for CPU tensors and count no launch."""
    tdt, jdt = DTYPES[dtype]
    x, w, bias = _inputs((2, 37, 256, 128), 2)
    lin = nn.Linear(256, 128)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T.copy()))
        lin.bias.copy_(torch.tensor(bias))
    mod = W8A8Linear.from_linear(lin.to(tdt))
    assert mod.w8.shape == (128, 256) and mod.w8.is_contiguous() and mod.bias.dtype == tdt
    leaf = {**w8a8_from_kernel(jnp.asarray(w).astype(jdt)), "bias": jnp.asarray(bias).astype(jdt)}
    before = (w8a8_linear.launches, quantize_rows.launches, rescale_bias.launches)
    got = apply_linear(mod, torch.tensor(x).to(tdt))
    assert (w8a8_linear.launches, quantize_rows.launches, rescale_bias.launches) == before
    ref = jax_linear(leaf, jnp.asarray(x).astype(jdt))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    q, sx = quantize_rows(torch.tensor(x[0]).to(tdt))
    assert q.shape == (37, 256) and sx.shape == (37,)


def test_w8a8_blocks_swaps_only_the_targets():
    """Six linears a block become W8A8Linear; the AdaLN modulations, the
    embeddings and proj_out stay float."""
    dit = w8a8_blocks_(DiT(DiTConfig(**TINY)))
    w8 = [name for name, m in dit.named_modules() if isinstance(m, W8A8Linear)]
    assert w8 == [f"transformer_blocks.{i}.{t}" for i in range(2) for t in W8A8_TARGETS]
    for name in ("transformer_blocks.0.attn_norm.linear", "proj_out", "time_embed.time_mlp.0", "input_embed.proj"):
        assert type(dit.get_submodule(name)) is nn.Linear


def test_w8a8_blocks_refuses_a_weight_only_quantized_dit():
    """As the JAX package's `w8a8_blocks`, with its message."""
    dit = quantize_module_(DiT(DiTConfig(**TINY)), 4)
    assert isinstance(dit.transformer_blocks[0].attn.to_q, QuantizedLinear)
    with pytest.raises(ValueError, match=r"weight-only quantized .*load the float snapshot for int8 compute"):
        w8a8_blocks_(dit)


@pytest.fixture(scope="module")
def models():
    """The same random tiny model in both packages, with int8_compute."""
    cfg = dict(TINY, int8_compute=True)
    jax_model = JaxF5TTS.init(
        jax.random.key(0), JaxDiTConfig(**cfg), cfm_cfg=JaxCFMConfig(duration_bucket=64),
        vocab_char_map=VOCAB, vocoder=JaxVocos.init(jax.random.key(1), JaxVocosConfig(**VOCOS)).decode,
    )
    dit = DiT(DiTConfig(**cfg))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_model.params), DiTConfig(**cfg)))
    vocos = Vocos(VocosConfig(**VOCOS))
    vocos.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jax_model._vocoder.__self__.params), VocosConfig(**VOCOS)))
    port = F5TTS(dit, DiTConfig(**cfg), cfm_cfg=CFMConfig(duration_bucket=64), vocab_char_map=VOCAB, vocoder=vocos)
    return jax_model, port


def test_w8a8_dit_forward_matches_jax(models):
    """One forward of the sampler's W8A8 DiT (the master's copy with its
    blocks re-quantized) against the JAX forward on `w8a8_blocks(params)`,
    with a ragged mask and one row's audio dropped. Tolerance 1e-4."""
    jax_model, port = models
    rng = np.random.default_rng(2)
    b, n = 2, 40
    x, cond = (rng.standard_normal((b, n, 100)).astype(np.float32) for _ in range(2))
    text = rng.integers(0, 95, (b, 30)).astype(np.int32)
    mask = np.arange(n)[None, :] < np.array([n, 31])[:, None]
    drop = np.array([False, True])
    p, cfg = w8a8_blocks(jax_model.params), jax_model.dit_cfg
    te = dit_text_embed(p, cfg, jnp.asarray(text), n)
    mods = jax.tree.map(lambda a: a[0], dit_time_mods(p, cfg, jnp.asarray([0.3], jnp.float32)))
    ref = dit_forward_precomputed(p, cfg, jnp.asarray(x), jnp.asarray(cond), te, None, drop_audio_cond=jnp.asarray(drop),
                                  mask=jnp.asarray(mask), time_mods=mods)
    dit = port._inference_dit()
    assert dit is not port.dit and isinstance(dit.transformer_blocks[1].ff.ff[0][0], W8A8Linear)
    tte = dit.embed_text(torch.tensor(text), n)
    tmods = {k: v[0] for k, v in dit.time_mods(torch.tensor([0.3])).items()}
    with torch.no_grad():
        got = dit(torch.tensor(x), torch.tensor(cond), tte, tmods, drop_audio_cond=torch.tensor(drop),
                  mask=torch.tensor(mask)).numpy()
    p = jax_model.params
    te, mods = dit_text_embed(p, cfg, jnp.asarray(text), n), jax.tree.map(
        lambda a: a[0], dit_time_mods(p, cfg, jnp.asarray([0.3], jnp.float32)))
    ref_float = dit_forward_precomputed(p, cfg, jnp.asarray(x), jnp.asarray(cond), te, None,
                                        drop_audio_cond=jnp.asarray(drop), mask=jnp.asarray(mask), time_mods=mods)
    _hold(got, ref, ref_float, 1e-3)


def _hold(got, ref, ref_float, atol):
    """Within `atol` of the JAX W8A8 result, and nearer to it than half its
    distance from the JAX float result (the module docstring's reasons)."""
    ref, ref_float = np.asarray(ref), np.asarray(ref_float)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    assert np.linalg.norm(got - ref) <= 0.5 * np.linalg.norm(ref_float - ref), (
        np.linalg.norm(got - ref), np.linalg.norm(ref_float - ref))


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_sample_int8_compute_matches_jax(models, method):
    """The whole slice with int8_compute on both sides and the same y0:
    reference wave -> mel -> text -> 4-step ODE with CFG through the W8A8
    DiT -> composite -> Vocos. Tolerances 5e-3 on the mel, 1e-3 on the
    wave (the module docstring's reasons)."""
    jax_model, port = models
    sr = 24_000
    rng = np.random.default_rng(5)
    wave = (0.1 * np.sin(2 * np.pi * 220 * np.arange(sr // 2) / sr)
            + 0.01 * rng.standard_normal(sr // 2)).astype(np.float32)
    y0 = rng.standard_normal((1, 100, 100)).astype(np.float32)
    kw = dict(duration=100, steps=4, method=method, cfg_strength=2.0, sway_sampling_coef=-1.0)
    ref_wave, ref_traj = jax_model.sample(jnp.asarray(wave)[None], ["hello there"], y0=jnp.asarray(y0), **kw)
    got_wave, got_traj = port.sample(wave[None], ["hello there"], y0=y0, **kw)
    assert got_wave.shape == ref_wave.shape and got_traj.shape == ref_traj.shape
    jax_model.dit_cfg = jax_model.dit_cfg.replace(int8_compute=False)
    try:
        float_wave, float_traj = jax_model.sample(jnp.asarray(wave)[None], ["hello there"], y0=jnp.asarray(y0), **kw)
    finally:
        jax_model.dit_cfg = jax_model.dit_cfg.replace(int8_compute=True)
    _hold(got_traj.numpy(), ref_traj, float_traj, 5e-3)
    _hold(got_wave.numpy(), ref_wave, float_wave, 1e-3)


def test_turning_the_flag_on_rebuilds_the_sampler_copy():
    """The cached bf16 copy is keyed on int8_compute: turning the flag on
    after a bf16 sample re-quantizes and changes the output; turning it off
    again gives the bf16 output back."""
    g = torch.Generator().manual_seed(0)
    model = F5TTS.init(g, DiTConfig(**TINY, compute_dtype="bfloat16"), device="cpu",
                       cfm_cfg=CFMConfig(duration_bucket=64), vocab_char_map=VOCAB)
    mel = np.random.default_rng(1).standard_normal((1, 20, 100)).astype(np.float32)

    def run():
        _, traj = model.sample(mel, ["hello"], duration=64, steps=2, method="euler", seed=0)
        return traj, model._inference_dit()

    bf16, copy_bf16 = run()
    model.dit_cfg = model.dit_cfg.replace(int8_compute=True)
    w8a8, copy_w8a8 = run()
    assert copy_w8a8 is not copy_bf16 and isinstance(copy_w8a8.transformer_blocks[0].attn.to_k, W8A8Linear)
    assert copy_w8a8.transformer_blocks[0].attn.to_k.bias.dtype == torch.bfloat16
    assert not torch.equal(w8a8, bf16)
    model.dit_cfg = model.dit_cfg.replace(int8_compute=False)
    again, _ = run()
    torch.testing.assert_close(again, bf16, rtol=0, atol=0)
