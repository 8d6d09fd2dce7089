"""The DiT's AdaLN LayerNorm + modulate (`ops/ln_modulate.py`) on the CPU.

CPU tensors of the operator run the blocks' own expression, so a block, a
whole DiT and their gradients equal that expression written out, bit for
bit, in bf16 and float32; without gradients the call is the registered
operator, which an exported program records once a norm, and whose fake
gives the CPU body's shape and dtype. The backward kernel's function
(`ln_modulate_bwd_plain`, from the statistics `ln_stats_plain` gives) is
held to float32 autograd of the forward kernel's (`ln_modulate_plain`), and
to `jax.vjp` of the JAX package's AdaLN (`adaln_zero`, `adaln_zero_final`)
in float32. The kernels themselves are tested on the card
(`tests/test_torch_cuda.py`), against these functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from f5_tts_tpu.models import blocks as JB
from f5_tts_tpu_torch.config import DiTConfig
from f5_tts_tpu_torch.models import blocks as B
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.rope import rotary_freqs
from f5_tts_tpu_torch.ops.ln_modulate import (
    ln_modulate,
    ln_modulate_bwd_plain,
    ln_modulate_chain,
    ln_modulate_plain,
    ln_stats_plain,
)
from f5_tts_tpu_torch.utils.modules import init_parameters_, layer_norm

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256, text_dim=32,
            conv_layers=1)
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
OP = torch.ops.f5_tts_tpu_torch.ln_modulate.default


def _explicit_chain(x, scale, shift):
    """The blocks' AdaLN before the operator, written out."""
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def _both_ways(monkeypatch, fn):
    """fn() through the operator, then with the blocks' call replaced by the
    written-out chain."""
    got = fn()
    with monkeypatch.context() as m:
        m.setattr(B, "ln_modulate", _explicit_chain)
        want = fn()
    return got, want


def _assert_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None and w is None) or (g.dtype == w.dtype and torch.equal(g, w))


def _tiny_dit(dtype: str) -> DiT:
    dit = DiT(DiTConfig(**TINY, compute_dtype="bfloat16" if dtype == "bf16" else "float32", dropout=0.1))
    init_parameters_(dit, torch.Generator().manual_seed(0))
    return dit


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_matches_the_chain_bit_for_bit(monkeypatch, dtype):
    """One DiTBlock with a key mask, RoPE and dropout: output and the
    gradients of x, the modulation and every parameter."""
    gen = torch.Generator().manual_seed(1)
    block = B.DiTBlock(64, 2, 32, 2)
    init_parameters_(block, gen)
    b, n, dt = 3, 37, DTYPES[dtype]
    x0 = torch.randn(b, n, 64, generator=gen).to(dt)
    mod0 = torch.randn(b, 6 * 64, generator=gen).to(dt)
    mask = torch.arange(n)[None] < torch.tensor([[n], [n - 5], [20]])
    raw = rotary_freqs(n, 32)
    rope = (torch.cos(raw), torch.sin(raw))
    cot = torch.randn(b, n, 64, generator=gen).to(dt)

    def run():
        x, mod = x0.clone().requires_grad_(), mod0.clone().requires_grad_()
        block.zero_grad(set_to_none=True)
        out = block(x, mod, mask=mask, rope=rope, dropout_rate=0.1, dropout_seed=7)
        out.backward(cot)
        return [out.detach(), x.grad, mod.grad, *(p.grad for p in block.parameters())]

    _assert_bits(*_both_ways(monkeypatch, run))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dit_training_forward_matches_the_chain_bit_for_bit(monkeypatch, dtype):
    """A 2-layer DiT's training forward with dropout (2 depth + 1 norms, the
    final one included) and every parameter's gradient."""
    dit = _tiny_dit(dtype)
    gen = torch.Generator().manual_seed(2)
    x, cond = torch.randn(2, 40, 100, generator=gen), torch.randn(2, 40, 100, generator=gen)
    text = torch.randint(0, 255, (2, 12), generator=gen)
    time = torch.rand(2, generator=gen)

    def run():
        dit.zero_grad(set_to_none=True)
        out = dit.forward_train(x, cond, text, time, generator=torch.Generator().manual_seed(3))
        out.square().mean().backward()
        return [out.detach(), *(p.grad for p in dit.parameters())]

    _assert_bits(*_both_ways(monkeypatch, run))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sampling_forward_matches_the_chain_bit_for_bit(monkeypatch, dtype):
    """The sampling forward under no_grad goes through the registered
    operator, with the [1, 6 dim] modulations broadcast over the batch."""
    dit = _tiny_dit(dtype)
    gen = torch.Generator().manual_seed(4)
    x, cond = torch.randn(2, 40, 100, generator=gen), torch.randn(2, 40, 100, generator=gen)
    text = torch.randint(0, 255, (2, 12), generator=gen)

    def run():
        with torch.no_grad():
            mods = dit.time_mods(torch.tensor([0.3]))
            one = {"blocks": mods["blocks"][0], "final": mods["final"][0]}
            return [dit(x, cond, dit.embed_text(text, 40), one, mask=torch.arange(40)[None] < 33)]

    _assert_bits(*_both_ways(monkeypatch, run))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_cpu_operator_is_the_chain(dtype, grad):
    """On chunk views of a [b, 6 d] and a [1, 6 d] modulation, with and
    without gradients, the CPU operator is the chain to the bit; in float32
    the chain is also the kernel's function to the bit."""
    gen = torch.Generator().manual_seed(5)
    dt = DTYPES[dtype]
    x = (torch.randn(4, 9, 48, generator=gen) * 2 + 0.5).to(dt)
    for rows in (4, 1):
        mod = torch.randn(rows, 6 * 48, generator=gen).to(dt)
        scale, shift = mod.chunk(6, dim=-1)[1], mod.chunk(6, dim=-1)[0]
        with torch.set_grad_enabled(grad):
            got = ln_modulate(x.clone().requires_grad_(grad), scale, shift)
        want = _explicit_chain(x, scale, shift)
        assert got.dtype == dt and torch.equal(got.detach(), want)
        assert torch.equal(ln_modulate_chain(x, scale, shift), want)
        if dtype == "f32":
            assert torch.equal(ln_modulate_plain(x, scale, shift), want)


def test_export_records_one_call_per_norm():
    """torch.export of a tiny DiT's sampling forward records 2 depth + 1
    calls of the operator, and the program gives the live forward's bits."""

    class Forward(torch.nn.Module):
        def __init__(self, dit):
            super().__init__()
            self.dit = dit

        def forward(self, x, cond, text_embed, blocks, final):
            return self.dit(x, cond, text_embed, {"blocks": blocks, "final": final})

    dit = _tiny_dit("bf16")
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        mods = dit.time_mods(torch.tensor([0.5]))
        args = (torch.randn(2, 24, 100, generator=gen), torch.randn(2, 24, 100, generator=gen),
                dit.embed_text(torch.randint(0, 255, (2, 8), generator=gen), 24), mods["blocks"][0], mods["final"][0])
        ep = torch.export.export(Forward(dit), args, strict=False)
        calls = [node for node in ep.graph.nodes if node.op == "call_function" and node.target is OP]
        assert len(calls) == 2 * TINY["depth"] + 1
        assert torch.equal(ep.module()(*args), Forward(dit)(*args))


@pytest.mark.parametrize("types", [("bf16", "bf16"), ("f32", "f32"), ("bf16", "f32"), ("f32", "bf16")])
def test_fake_gives_the_shape_and_dtype_of_the_cpu_body(types):
    """The fake (export, tracing) returns what the CPU body returns: x's
    shape, the promoted dtype, for a broadcast [1, d] and a per-item
    [b, d] modulation."""
    x_dt, mod_dt = (DTYPES[t] for t in types)
    for rows in (1, 3):
        x, mod = torch.randn(3, 5, 8).to(x_dt), torch.randn(rows, 16).to(mod_dt)
        real = OP(x, *mod.chunk(2, dim=-1))
        with FakeTensorMode() as mode:
            fake = OP(mode.from_tensor(x), *mode.from_tensor(mod).chunk(2, dim=-1))
        assert fake.shape == real.shape == x.shape and fake.dtype == real.dtype


@pytest.mark.parametrize("rows", [3, 1], ids=["per_item", "broadcast"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backward_function_matches_float32_autograd(rows, dtype):
    """dx = rstd (g - mean(g) - xhat mean(g xhat)), g = dy (1 + scale), and
    the column sums of dy xhat and dy (summed over the batch for a [1, d]
    scale) against float32 autograd of the forward kernel's function, from
    bf16 or float32 x, dy and scale."""
    gen = torch.Generator().manual_seed(8)
    dt = DTYPES[dtype]
    x = (torch.randn(3, 50, 96, generator=gen) * 2 + 0.5).to(dt)
    dy = torch.randn(3, 50, 96, generator=gen).to(dt)
    scale, shift = (torch.randn(rows, 96, generator=gen).to(dt) for _ in range(2))
    got = ln_modulate_bwd_plain(x, dy, scale, *ln_stats_plain(x))
    xf, sf, tf = (t.float().requires_grad_() for t in (x, scale, shift))
    ln_modulate_plain(xf, sf, tf).backward(dy.float())
    for g, w in zip(got, (xf.grad, sf.grad, tf.grad)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-5 * max(1.0, w.abs().max().item())


@pytest.mark.parametrize("rows", [3, 1], ids=["per_item", "broadcast"])
@pytest.mark.parametrize("norm", ["block", "final"])
def test_backward_function_matches_jax_vjp(norm, rows):
    """dx, dscale and dshift of `ln_modulate_bwd_plain` against `jax.vjp`
    of the JAX package's AdaLN in float32: the block's `adaln_zero` (scale
    and shift from a [b or 1, 6 d] modulation) and the final norm's
    `adaln_zero_final` ([b or 1, 2 d]), the gradient reaching the
    modulation's scale and shift columns; absolute 1e-5 of the larger of 1
    and the JAX gradient's largest magnitude (the same float32 math summed
    in another order)."""
    rng = np.random.default_rng(9)
    b, n, d = 3, 50, 96
    x = (rng.standard_normal((b, n, d)) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal((b, n, d)).astype(np.float32)
    parts = 6 if norm == "block" else 2
    mod = (rng.standard_normal((rows, parts * d)) * 0.5).astype(np.float32)
    if norm == "block":  # split order shift_msa, scale_msa, ...
        def jax_fn(x, mod):
            return JB.adaln_zero(None, x, None, mod=mod)[0]
        shift_col, scale_col = 0, 1
    else:  # split order scale, shift
        def jax_fn(x, mod):
            return JB.adaln_zero_final(None, x, None, mod=mod)
        shift_col, scale_col = 1, 0
    _, vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(mod))
    jdx, jdmod = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    cols = [jdmod[:, c * d:(c + 1) * d] for c in range(parts)]
    tx = torch.tensor(x)
    scale = torch.tensor(mod).chunk(parts, dim=-1)[scale_col]
    got = ln_modulate_bwd_plain(tx, torch.tensor(dy), scale, *ln_stats_plain(tx))
    for name, g, w in zip(("dx", "dscale", "dshift"), got, (jdx, cols[scale_col], cols[shift_col])):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * max(1.0, float(np.abs(w).max())), rtol=0,
                                   err_msg=name)
