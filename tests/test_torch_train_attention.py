"""The port's attention backward, dropout and infill masks against the JAX
package, on the CPU.

The attention gradients come from `jax.grad` through the JAX
`flash_attention`, whose custom VJP runs the Pallas backward kernel (K2) in
interpret mode on the CPU, and from `torch.autograd.grad` through the port's
`flash_attention`, whose backward on CPU tensors is
`flash_attention_bwd_plain`. Tolerances: 1e-5 absolute in float32 on O(1)
gradients (the same float32 math summed in another order); 3e-2 absolute in
bf16 (both sides round the rotated q and k, P and dS to bf16 at slightly
different points: one or two bf16 ulps at magnitude 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import blocks as JB
from f5_tts_tpu.models import rope as jrope
from f5_tts_tpu.ops.flash_attention import flash_attention as jax_flash
from f5_tts_tpu.utils import masks as jmasks
from f5_tts_tpu_torch.models import blocks as B
from f5_tts_tpu_torch.ops.attention import scaled_dot_product_attention
from f5_tts_tpu_torch.ops.flash_attention import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from f5_tts_tpu_torch.utils import masks as tmasks


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((2, 2, n, 64)).astype(np.float32) for _ in range(4))
    raw = np.asarray(jrope.rotary_freqs(n, 64))
    mask = np.arange(n)[None, :] < np.array([n - 10, n])[:, None]
    return q, k, v, w, np.cos(raw), np.sin(raw), mask


def _port_grads(q, k, v, w, mask, rope, dtype):
    tq, tk, tv = (torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, 0.125, key_mask=mask, rope=rope)
    return torch.autograd.grad(out, (tq, tk, tv), torch.tensor(w).to(dtype))


def _jax_grads(q, k, v, w, mask, rope, dtype):
    def loss(q, k, v):
        return (jax_flash(q, k, v, 0.125, mask, rope=rope).astype(jnp.float32) * w).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a, dtype) for a in (q, k, v)))


@pytest.mark.parametrize("n", [32, 37])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_rope", [False, True])
def test_attention_backward_matches_pallas_k2(n, with_mask, with_rope):
    q, k, v, w, cos, sin, mask = _inputs(n, seed=n)
    jm = jnp.asarray(mask) if with_mask else None
    jr = (jnp.asarray(cos), jnp.asarray(sin)) if with_rope else None
    tm = torch.tensor(mask) if with_mask else None
    tr = (torch.tensor(cos), torch.tensor(sin)) if with_rope else None
    ref = _jax_grads(q, k, v, w, jm, jr, jnp.float32)
    got = _port_grads(q, k, v, w, tm, tr, torch.float32)
    for name, a, b in zip("qkv", got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0, err_msg=f"d{name}")


def test_attention_backward_bf16_matches_pallas_k2():
    q, k, v, w, cos, sin, mask = _inputs(37, seed=3)
    ref = _jax_grads(q, k, v, w, jnp.asarray(mask), (jnp.asarray(cos), jnp.asarray(sin)), jnp.bfloat16)
    got = _port_grads(q, k, v, w, torch.tensor(mask), (torch.tensor(cos), torch.tensor(sin)), torch.bfloat16)
    for name, a, b in zip("qkv", got, ref):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), atol=3e-2, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_rope", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(with_mask, with_rope):
    """flash_attention_bwd_plain against autograd through
    flash_attention_plain, float32, atol 1e-5. (Rows whose keys are all
    masked are left out: masked_fill stops their score gradient, where K2's
    additive bias passes it, as the JAX kernel's does.)"""
    q, k, v, w, cos, sin, mask = _inputs(29, seed=7)
    tm = torch.tensor(mask) if with_mask else None
    tr = (torch.tensor(cos), torch.tensor(sin)) if with_rope else None
    tq, tk, tv = (torch.tensor(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_plain(tq, tk, tv, 0.125, tm, tr)
    ref = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(w))
    got = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(), out.detach(), torch.tensor(w),
                                    0.125, tm, tr)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_flash_attention_uses_the_autograd_function_only_with_grad():
    q, k, v, _, cos, sin, _ = _inputs(16, seed=9)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    rope = (torch.tensor(cos), torch.tensor(sin))
    assert flash_attention(tq, tk, tv, 0.125, rope=rope).grad_fn is None
    out = flash_attention(tq.requires_grad_(), tk, tv, 0.125, rope=rope)
    assert type(out.grad_fn).__name__ == f"{FlashAttentionFn.__name__}Backward"
    with torch.no_grad():
        assert flash_attention(tq, tk, tv, 0.125, rope=rope).grad_fn is None


def test_partial_rope_rotation_stays_differentiable():
    """A rotation of part of the head is applied outside the kernel; the
    gradient through it matches JAX autograd of the same attention."""
    q, k, v, w, cos, sin, _ = _inputs(24, seed=11)
    half = (cos[:, :32], sin[:, :32])

    def jloss(q, k, v):
        qr, kr = jrope.apply_rotary_pos_emb(q, half), jrope.apply_rotary_pos_emb(k, half)
        return (jax_flash(qr, kr, v, 0.125, None) * w).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.tensor(a).requires_grad_() for a in (q, k, v))
    out = scaled_dot_product_attention(tq, tk, tv, 0.125, rope=tuple(torch.tensor(t) for t in half))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(w))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ dropout


def test_dropout_rate_zero_is_identity_and_inverted_scaling_keeps_the_mean():
    x = torch.ones(1000, 64)
    g = torch.Generator().manual_seed(0)
    torch.testing.assert_close(B.dropout(x, 0.0, g), x, rtol=0, atol=0)
    out = B.dropout(x, 0.5, g)
    kept = (out != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.05
    assert abs(out.mean().item() - 1.0) < 0.05  # as the JAX dropout (tests/test_dropout.py)
    assert set(out.unique().tolist()) <= {0.0, 2.0}
    j = JB.dropout(jnp.ones((1000, 64)), 0.5, jax.random.key(0))
    assert abs(float(j.mean()) - out.mean().item()) < 0.05


def test_dropout_is_deterministic_per_seed():
    x = torch.randn(4, 50, 32, generator=torch.Generator().manual_seed(1))
    a = B.dropout(x, 0.3, torch.Generator().manual_seed(5))
    b = B.dropout(x, 0.3, torch.Generator().manual_seed(5))
    c = B.dropout(x, 0.3, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    ga, gb = B.dropout_generators(7, 2, x.device)
    assert not torch.equal(B.dropout(x, 0.3, ga), B.dropout(x, 0.3, gb))
    assert B.dropout_generators(None, 2, x.device) == [None, None]


# ------------------------------------------------------------------ masks


def test_mask_from_frac_lengths_matches_jax():
    """The same uniforms on both sides: JAX draws them inside
    mask_from_frac_lengths from its key; the port takes them as a tensor."""
    lens = np.array([40, 23, 1, 64], np.int32)
    for seed in range(5):
        key = jax.random.key(seed)
        frac = jax.random.uniform(jax.random.key(100 + seed), (4,), minval=0.7, maxval=1.0)
        ref = jmasks.mask_from_frac_lengths(key, jnp.asarray(lens), frac, 64)
        rand = jax.random.uniform(key, (4,))  # the draw JAX makes inside
        got = tmasks.mask_from_frac_lengths(torch.tensor(lens), torch.tensor(np.asarray(frac)),
                                            torch.tensor(np.asarray(rand)), 64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    start, end = np.array([0, 3]), np.array([5, 3])
    np.testing.assert_array_equal(
        tmasks.mask_from_start_end_indices(torch.tensor(start), torch.tensor(end), 8).numpy(),
        np.asarray(jmasks.mask_from_start_end_indices(jnp.asarray(start), jnp.asarray(end), 8)))
