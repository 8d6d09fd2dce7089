"""The probe tools' kernels P1-P5 and compositions in the PyTorch port against
the JAX package's probe tools, on the CPU.

`tools/attn_variants.py` and `tools/fusion_probe.py` are loaded from their
files under private module names, and each module's `pl` is replaced by a
shim whose `pallas_call` runs in interpret mode, so the Pallas kernels run
on the CPU unedited. Inputs are made with numpy from a seed at
[1, 2, 128, d], d 64 and 128 (P5 at [2, 256, 128]). Tolerances, absolute:
1e-5 in float32 (the same float32 math summed in another order), 1e-2 in
bf16 (the plain versions round where the Pallas bodies round; XLA may keep
a bf16 intermediate in float32, which moves the output by an ulp).
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.models import blocks as JB
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.utils.modules import conv1d as jax_conv1d
from f5_tts_tpu.utils.modules import conv1d_init
from f5_tts_tpu.utils.modules import linear as jax_linear
from f5_tts_tpu_torch.config import DiTConfig
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.ops import attn_variants as AV
from f5_tts_tpu_torch.ops.ln_modulate import ln_modulate, ln_modulate_plain
from f5_tts_tpu_torch.tools import attn_variants as port_attn_tool
from f5_tts_tpu_torch.tools import fusion_probe as FP

ROOT = Path(__file__).resolve().parents[1]
TOL = {"f32": 1e-5, "bf16": 1e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_probe_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(BlockSpec=pl.BlockSpec,
                                   pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return mod


@pytest.fixture(scope="module")
def tools():
    return _load_tool("attn_variants"), _load_tool("fusion_probe")


def _both(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, dtype=jd), torch.tensor(x).to(td)


def _close(got: torch.Tensor, ref, dtype: str):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=TOL[dtype], rtol=0)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name", ["attn_pack2", "attn_flat"])
def test_attention_variants_match_pallas(tools, name, d, dtype):
    """P1 and P2: the plain versions against the Pallas kernels, at n = 128
    and at a ragged n = 100 with b * h = 4 (the kernels on the card pad
    to 128-row and 64-row blocks; their card tests hold them to these plain
    versions)."""
    jav, _ = tools
    scale = 1.0 / np.sqrt(d)
    for i, shape in enumerate(((1, 2, 128, d), (2, 2, 100, d))):
        pairs = [_both(x, dtype) for x in _qkv(shape, seed=d + 1000 * i)]
        ref = getattr(jav, name)(*(p[0] for p in pairs), scale)
        got = getattr(AV, name)(*(p[1] for p in pairs), scale)
        assert got.dtype == DTYPES[dtype][1] and got.shape == shape
        _close(got, ref.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("perm", ["pair swap", "random"])
@pytest.mark.parametrize("name", ["flash_bhnd_rope", "flash_nhd"])
def test_rope_attention_matches_pallas(tools, name, perm, d, dtype):
    """P3 ([b, n, h, d]) and P4 ([b, h, n, d]): the plain versions against
    the Pallas kernels, with the tool's pair-swap P and with a random P (P
    is an input of the kernel, not hard-wired)."""
    _, jfp = tools
    shape = (1, 128, 2, d) if name == "flash_nhd" else (1, 2, 128, d)
    pairs = [_both(x, dtype) for x in _qkv(shape, seed=d + 1)]
    cos, sin = (np.asarray(t) for t in jfp.rope_tables(128, d))
    P = jfp.perm_matrix(d) if perm == "pair swap" else \
        (np.random.default_rng(3).standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    ref = getattr(jfp, name)(*(p[0] for p in pairs), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(P), scale)
    got = getattr(AV, name)(*(p[1] for p in pairs), torch.tensor(cos), torch.tensor(sin), torch.tensor(P), scale)
    assert got.dtype == DTYPES[dtype][1] and got.shape == shape
    _close(got, ref.astype(jnp.float32), dtype)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value's magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("perm", ["pair swap", "random"])
@pytest.mark.parametrize("layout", ["bhnd", "nhd"])
def test_rope_prepass_matches_the_pallas_rotation(tools, layout, perm, d):
    """The RoPE kernels' pre-pass (its plain version) against the Pallas
    bodies' rotation, q * cos + bf16(q @ P) * sin in bf16, computed op by op
    in jnp for each head: equal for the pair swap (one nonzero term a
    column, so no sum to reorder); for a random P within one bf16 ulp of the
    result or of its larger term (the float32 sums of x @ P in another order
    may round bf16(x @ P) the other way, which moves its term by up to an ulp
    of that term, also where the two terms cancel); the rows past n are
    zero."""
    _, jfp = tools
    b, h, n, n_pad = 2, 3, 100, 128
    rng = np.random.default_rng(d + 11)
    shape = (b, n, h, d) if layout == "nhd" else (b, h, n, d)
    q, k = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    cos, sin = (np.asarray(t) for t in jfp.rope_tables(n, d))
    P = jfp.perm_matrix(d) if perm == "pair swap" else \
        (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    tq, tk = (torch.tensor(x).to(torch.bfloat16) for x in (q, k))
    if layout == "nhd":
        tq, tk = tq.transpose(1, 2), tk.transpose(1, 2)
    got = AV.rope_prepass_plain(tq, tk, torch.tensor(cos), torch.tensor(sin), torch.tensor(P), n_pad)
    bf = jnp.bfloat16
    c, s, Pb = jnp.asarray(cos, bf), jnp.asarray(sin, bf), jnp.asarray(P, bf)
    for x, out in zip((q, k), got):
        assert out.dtype == torch.bfloat16 and out.shape == (b * h, n_pad, d)
        xh = x.transpose(0, 2, 1, 3) if layout == "nhd" else x
        for i in range(b * h):
            xj = jnp.asarray(xh[i // h, i % h], bf)
            terms = (xj * c, jax.lax.dot(xj, Pb, preferred_element_type=jnp.float32).astype(bf) * s)
            ref = np.asarray((terms[0] + terms[1]).astype(jnp.float32))
            row = out[i, :n].float().numpy()
            if perm == "pair swap":
                np.testing.assert_array_equal(row, ref)
            else:
                big = np.maximum(*(np.abs(np.asarray(t.astype(jnp.float32))) for t in terms))
                assert (np.abs(row - ref) <= np.maximum(_bf16_ulp(ref), _bf16_ulp(big))).all()
        assert not out[:, n:].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ln_modulate_matches_pallas(tools, dtype):
    """P5 at [2, 256, 128], n a multiple of the TPU kernel's 256-row block:
    its kernel's function, `ln_modulate_plain` (CPU tensors of the operator
    run the DiT blocks' chain, which rounds twice in bf16)."""
    _, jfp = tools
    rng = np.random.default_rng(4)
    x, scale, shift = (_both(rng.standard_normal(s).astype(np.float32) * 2 + 0.5, dtype)
                       for s in ((2, 256, 128), (2, 128), (2, 128)))
    ref = jfp.ln_modulate_pallas(x[0], scale[0], shift[0])
    got = ln_modulate_plain(x[1], scale[1], shift[1])
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, 256, 128)
    _close(got, ref.astype(jnp.float32), dtype)


def test_ln_modulate_computes_every_row(tools):
    """At n = 300 the TPU kernel writes rows [0, 256) only; the port writes
    every row, and each row is its own LayerNorm + modulate."""
    _, jfp = tools
    rng = np.random.default_rng(5)
    x, scale, shift = (rng.standard_normal(s).astype(np.float32) for s in ((2, 300, 128), (2, 128), (2, 128)))
    ref = np.asarray(jfp.ln_modulate_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift)))
    got = ln_modulate(torch.tensor(x), torch.tensor(scale), torch.tensor(shift))
    np.testing.assert_allclose(got[:, :256].numpy(), ref[:, :256], atol=TOL["f32"], rtol=0)
    tail = ln_modulate_plain(torch.tensor(x[:, 256:]), torch.tensor(scale), torch.tensor(shift))
    torch.testing.assert_close(got[:, 256:], tail, atol=0, rtol=0)


def test_rope_tables_and_perm_matrix_match_the_tool(tools):
    _, jfp = tools
    for d in (64, 128):
        np.testing.assert_array_equal(FP.perm_matrix(d), jfp.perm_matrix(d))
        for got, ref in zip(FP.rope_tables(1024, d), jfp.rope_tables(1024, d)):
            assert got.shape == (1024, d) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    # the product form of the rotation is the rotation
    x = torch.tensor(np.random.default_rng(6).standard_normal((3, 128, 64)).astype(np.float32))
    cos, sin = FP.rope_tables(128, 64)
    from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb

    torch.testing.assert_close(x * cos + (x @ torch.tensor(FP.perm_matrix(64))) * sin,
                               apply_rotary_pos_emb(x, (cos, sin)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("variant", ["grouped conv (F.conv1d, groups=16)", "grouped conv as per-group batched GEMM",
                                     "grouped conv as 31-tap einsum sum"])
def test_probe_conv_variants_match_jax_conv1d(variant):
    """The grouped k31 conv (dim 128, 16 groups) in float32, each variant on
    the JAX conv's weights carried over in the port's layout."""
    p = conv1d_init(jax.random.key(0), 128, 128, 31, groups=16)
    x = np.random.default_rng(7).standard_normal((2, 40, 128)).astype(np.float32)
    ref = jax_conv1d(p, jnp.asarray(x), groups=16)
    weight = torch.tensor(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)).copy())  # [out, in/g, k]
    fn = FP.conv_variants(weight, torch.tensor(np.asarray(p["bias"])), 16)[variant]
    got = fn(torch.tensor(x))
    assert got.shape == (2, 40, 128)
    _close(got, ref, "f32")


TINY = dict(dim=64, depth=1, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256, text_dim=32,
            conv_layers=1)


@pytest.fixture(scope="module")
def layer(tools):
    """An attention_init tree of the JAX package, carried into the port's
    `blocks.Attention` by `params_from_jax` as a one-block DiT's attention."""
    params = JaxF5TTS.init(jax.random.key(0), JaxDiTConfig(**TINY)).params
    attn_tree = JB.attention_init(jax.random.key(1), 64, 2, 32)
    params["blocks"]["attn"] = jax.tree.map(lambda a: a[None], attn_tree)
    dit = DiT(DiTConfig(**TINY))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), DiTConfig(**TINY)))
    return attn_tree, dit.transformer_blocks[0].attn


@pytest.mark.parametrize("variant", ["layer: current (blocks.Attention, K1)",
                                     "layer: projections + P4 + out projection",
                                     "layer: projections + P3 ([b, n, h, d]) + out projection",
                                     "layer: plain sdpa"])
def test_probe_layer_matches_jax(tools, layer, variant):
    """Each composition of `probe_layer` in float32 against JAX's: the
    projections + P4 (or P3) + out projection against the same composition
    around the Pallas kernel, the other two against `blocks.attention`."""
    _, jfp = tools
    attn_tree, attn = layer
    b, n, heads, d = 2, 40, 2, 32
    x = np.random.default_rng(8).standard_normal((b, n, 64)).astype(np.float32)
    cos, sin = jfp.rope_tables(n, d)
    P = jfp.perm_matrix(d)
    if "projections" in variant:
        nhd = "P3" in variant
        xj = jnp.asarray(x)
        q, k, v = (jax_linear(attn_tree[name], xj).reshape(b, n, heads, d) for name in ("to_q", "to_k", "to_v"))
        if nhd:
            o = jfp.flash_nhd(q, k, v, cos, sin, jnp.asarray(P), 1.0 / np.sqrt(d))
        else:
            q, k, v = (t.transpose(0, 2, 1, 3) for t in (q, k, v))
            o = jfp.flash_bhnd_rope(q, k, v, cos, sin, jnp.asarray(P), 1.0 / np.sqrt(d)).transpose(0, 2, 1, 3)
        ref = jax_linear(attn_tree["to_out"], o.reshape(b, n, heads * d))
    else:
        ref = JB.attention(attn_tree, jnp.asarray(x), heads, mask=None, rope_freqs=(cos, sin), use_flash=False)
    fns = FP.layer_variants(attn, (torch.tensor(np.asarray(cos)), torch.tensor(np.asarray(sin))), torch.tensor(P))
    with torch.no_grad():
        got = fns[variant](torch.tensor(x))
    _close(got, ref, "f32")


@pytest.mark.parametrize("entry", ["attn_variants", "fusion_probe", "int8_probe"])
def test_tools_time_on_the_card_only(entry):
    """The tools' entry points refuse a CPU device rather than timing it."""
    from f5_tts_tpu_torch.tools import int8_probe

    main = {"attn_variants": port_attn_tool.main, "fusion_probe": FP.main, "int8_probe": int8_probe.main}[entry]
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(device="cpu")


def test_attn_variants_tool_lists_the_five_variants():
    q, k, v = (torch.tensor(x) for x in _qkv((1, 2, 64, 64), seed=9))
    fns = port_attn_tool.variants(0.125)
    assert len(fns) == 5
    ref = fns[port_attn_tool.UNFUSED](q, k, v)
    for name, fn in fns.items():
        torch.testing.assert_close(fn(q, k, v), ref, atol=1e-5, rtol=0, msg=name)
