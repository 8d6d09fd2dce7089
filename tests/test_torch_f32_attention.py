"""The numerics of the float32 attention kernels (K1-f32, K2-f32), on the CPU.

The kernels run their products on the tensor cores in 3xTF32: each float32
operand x is split into hi = x rounded to TF32 and lo = (x - hi) rounded to
TF32, and a product a*b is summed as lo_a*hi_b + hi_a*lo_b, then hi_a*hi_b,
in float32. `tf32_split_plain` is that split in plain PyTorch, bit-exact to
`cvt.rna.tf32.f32`. Here the split is checked bit for bit, and attention and
its three gradients with every product emulated in 3xTF32 (TF32 products are
exact in float32, so a float32 matmul of split operands is the tensor core's
product up to the order of its sums) are held to the JAX kernel in interpret
mode at 1e-4, the float32 kernels' tolerance against their plain versions.
Single-pass TF32 (hi_a*hi_b alone) misses that tolerance, which is why the
kernels take three products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import rope as jrope
from f5_tts_tpu.ops.flash_attention import flash_attention as jax_flash
from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb, rotate_half
from f5_tts_tpu_torch.ops.flash_attention import tf32_split_plain

F32_TOL = 1e-4  # absolute on O(1) outputs and gradients, as the kernels are held to their plain versions


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """TF32 rounding computed in float64 from the value, not the bits: the
    nearest multiple of the TF32 ulp (2^(e - 10)), ties away from zero."""
    x = x.astype(np.float64)
    e = np.floor(np.log2(np.abs(x)))
    ulp = np.exp2(e - 10)
    q = np.abs(x) / ulp
    return (np.sign(x) * np.floor(q + 0.5) * ulp).astype(np.float32)


def test_split_rounds_to_nearest_ties_away_and_keeps_the_residual():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000) * np.exp2(rng.uniform(-30, 30, 200_000))).astype(np.float32)
    hi, lo = tf32_split_plain(torch.tensor(x))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # the low 13 mantissa bits are zero
    np.testing.assert_array_equal(hi.numpy(), _rna_reference(x))
    resid = x - hi.numpy()  # exact in float32
    nz = resid != 0
    np.testing.assert_array_equal(lo.numpy()[nz], _rna_reference(resid[nz]))
    assert not lo.numpy()[~nz].any()
    resid = np.abs(x.astype(np.float64) - hi.numpy() - lo.numpy())
    assert (resid <= 2.0 ** -22 * np.abs(x)).all()
    # ties: halfway between two TF32 values rounds away from zero (to nearest even would give 1 here)
    tie = np.float32(1 + 2.0 ** -11)
    below = np.nextafter(tie, np.float32(0))
    got = tf32_split_plain(torch.tensor([tie, -tie, below, 1 + 3 * 2.0 ** -11], dtype=torch.float32))[0]
    np.testing.assert_array_equal(got.numpy(), np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1, 1 + 2.0 ** -9],
                                                        np.float32))
    assert tf32_split_plain(torch.tensor([0.0]))[0].item() == 0.0


def _mm3(a, b):
    ah, al = tf32_split_plain(a)
    bh, bl = tf32_split_plain(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm1(a, b):
    return tf32_split_plain(a)[0] @ tf32_split_plain(b)[0]


def _emulated(mm, q, k, v, g, scale, mask, rope):
    """Attention (output and dq, dk, dv for the output gradient g) as the
    kernels compute it, each product through `mm`: masked keys biased by
    -1e30, the RoPE forward before and its backward after, delta =
    rowsum(g * out)."""
    qr, kr = (q, k) if rope is None else (apply_rotary_pos_emb(q, rope), apply_rotary_pos_emb(k, rope))
    s = mm(qr, kr.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + torch.where(mask, 0.0, -1e30)[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = mm(p, v)
    delta = (g * out).sum(-1, keepdim=True)
    dv = mm(p.transpose(-1, -2), g)
    ds = p * (mm(g, v.transpose(-1, -2)) - delta) * scale
    dq, dk = mm(ds, kr), mm(ds.transpose(-1, -2), qr)
    if rope is not None:
        cos, sin = rope
        dq, dk = (x * cos - rotate_half(x * sin) for x in (dq, dk))
    return out, dq, dk, dv


def _jax_reference(q, k, v, g, scale, mask, rope):
    jm = None if mask is None else jnp.asarray(mask)
    jr = None if rope is None else tuple(jnp.asarray(t) for t in rope)

    def f(q, k, v):
        return jax_flash(q, k, v, scale, jm, rope=jr)

    out, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    return (out, *vjp(jnp.asarray(g)))


def _case(b, h, n, d, valid, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    raw = np.asarray(jrope.rotary_freqs(n, d))
    rope = (np.cos(raw), np.sin(raw))
    mask = None if valid is None else np.arange(n)[None, :] < np.asarray(valid)[:, None]
    return q, k, v, g, mask, rope


def _errors(mm, case):
    q, k, v, g, mask, rope = case
    scale = q.shape[-1] ** -0.5
    ref = _jax_reference(q, k, v, g, scale, mask, rope)
    got = _emulated(mm, *(torch.tensor(t) for t in (q, k, v, g)), scale,
                    None if mask is None else torch.tensor(mask), tuple(torch.tensor(t) for t in rope))
    return [float(np.abs(a.numpy() - np.asarray(r)).max()) for a, r in zip(got, ref)]


# (b, h, n, d, valid keys per batch row or None): the duration predictor's shape with RoPE, and a small
# shape with a key mask
CASES = [(1, 8, 187, 64, None), (2, 2, 37, 64, [27, 37])]


@pytest.mark.parametrize("shape", CASES, ids=["duration-187", "masked-37"])
def test_3xtf32_attention_and_gradients_match_the_jax_kernel(shape):
    errs = _errors(_mm3, _case(*shape, seed=shape[2]))
    assert max(errs) <= F32_TOL, dict(zip(("out", "dq", "dk", "dv"), errs))


def test_single_pass_tf32_misses_the_float32_tolerance():
    """One TF32 product (hi*hi') per float32 product: the output or a
    gradient lands farther than 1e-4 from the JAX kernel at the duration
    predictor's shape, with the seed fixed."""
    errs = _errors(_mm1, _case(*CASES[0], seed=CASES[0][2]))
    assert max(errs) > F32_TOL, dict(zip(("out", "dq", "dk", "dv"), errs))
