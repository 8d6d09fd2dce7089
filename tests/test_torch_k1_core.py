"""K1's bf16 pre-pass (the rotation of q and k and the key biases that the
TMA + wgmma core reads) against the JAX kernel body, on the CPU.

`flash_prepass_plain` is the pre-pass kernel's function (the card tests hold
the kernel to it bit for bit). Here it is held to what the Pallas body of
`f5_tts_tpu/ops/flash_attention.py` computes, op by op in eager jnp so that
each bf16 op rounds as the body's does: q * cos + dot(q, P).astype(bf16) *
sin with P = `rope_perm_matrix`, and the key bias -(1 - mask) * 1e30 over
the mask the JAX wrapper pads with False. Inputs are made with numpy from a
seed. No tolerance: the rotation is three bf16 roundings on both sides (the
pair swap makes dot(q, P) exact), so the results are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import rope as jrope
from f5_tts_tpu.ops.flash_attention import flash_attention as jax_flash
from f5_tts_tpu.ops.flash_attention import rope_perm_matrix
from f5_tts_tpu_torch.ops import flash_attention as fa


def _inputs(b, h, n, d, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(2))
    raw = np.asarray(jrope.rotary_freqs(n, d))
    mask = np.arange(n)[None, :] < np.array([n - 61, n])[:, None]
    return q, k, np.cos(raw), np.sin(raw), mask


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """bf16 values (exact in float32) as their 16-bit patterns."""
    return (x.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)


@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("n", [130, 937])
def test_prepass_plain_matches_the_jax_body_bit_for_bit(n, d, with_mask):
    b, h = 2, 2
    n_pad = -(-n // fa.CORE_ROW_PAD) * fa.CORE_ROW_PAD
    q, k, cos, sin, mask = _inputs(b, h, n, d, seed=n + d)
    tq, tk = (torch.tensor(x).to(torch.bfloat16) for x in (q, k))
    key_mask = torch.tensor(mask) if with_mask else None
    qr, kr, kbias = fa.flash_prepass_plain(tq, tk, key_mask, (torch.tensor(cos), torch.tensor(sin)), n_pad)

    bf = jnp.bfloat16
    c, s, P = jnp.asarray(cos, bf), jnp.asarray(sin, bf), jnp.asarray(rope_perm_matrix(d), bf)
    for x, got in ((q, qr), (k, kr)):
        assert got.dtype == torch.bfloat16 and got.shape == (b * h, n_pad, d)
        xj = jnp.asarray(x, bf)
        ref = xj * c + jnp.matmul(xj, P, preferred_element_type=jnp.float32).astype(bf) * s
        ref = np.asarray(ref.astype(jnp.float32)).reshape(b * h, n, d)
        np.testing.assert_array_equal(_bf16_bits(got[:, :n].float().numpy()), _bf16_bits(ref))
        assert not got[:, n:].any()

    if not with_mask:
        assert kbias is None
        return
    padded = np.pad(mask, [(0, 0), (0, n_pad - n)])  # the JAX wrapper masks its padded keys
    ref_bias = np.asarray(-(1.0 - jnp.asarray(padded).astype(jnp.float32)) * 1e30)
    assert kbias.dtype == torch.float32 and kbias.shape == (b, n_pad)
    np.testing.assert_array_equal(kbias.numpy(), ref_bias)


def test_prepass_plain_without_rope_writes_only_the_biases():
    """Without RoPE the core reads q and k in place: no rotated halves; with
    neither a mask, nothing at all."""
    q, k, _, _, mask = _inputs(1, 2, 50, 64, seed=3)
    tq, tk = (torch.tensor(x[:1]).to(torch.bfloat16) for x in (q, k))
    qr, kr, kbias = fa.flash_prepass_plain(tq, tk, torch.tensor(mask[:1]), None, 128)
    assert qr is None and kr is None
    np.testing.assert_array_equal(kbias[0, :50].numpy(), np.where(mask[0], 0.0, -1e30).astype(np.float32))
    assert (kbias[0, 50:] == -1e30).all()
    assert fa.flash_prepass_plain(tq, tk, None, None, 128) == (None, None, None)


def test_prepass_wrapper_runs_the_plain_version_on_cpu_tensors():
    q, k, cos, sin, mask = _inputs(2, 3, 70, 64, seed=4)
    args = ((torch.tensor(q).to(torch.bfloat16), torch.tensor(k).to(torch.bfloat16), torch.tensor(mask),
             (torch.tensor(cos), torch.tensor(sin)), 128))
    before = fa.flash_prepass.launches
    for got, want in zip(fa.flash_prepass(*args), fa.flash_prepass_plain(*args)):
        assert torch.equal(got, want)
    assert fa.flash_prepass.launches == before  # only a launch counts


@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
def test_attention_over_the_prepass_matches_the_pallas_kernel(with_mask):
    """The composition the card runs, in bf16 on the CPU: attention over the
    plain pre-pass's rotated halves (its first n rows) with the key biases
    added to the scores, against the JAX Pallas kernel (interpret mode) on
    the same bf16 inputs. Both round the rotated q and k and P to bf16; the
    tolerance is bf16's (1e-2 on O(1) outputs)."""
    b, h, n, d = 2, 2, 100, 64
    q, k, cos, sin, mask = _inputs(b, h, n, d, seed=5)
    v = np.random.default_rng(6).standard_normal((b, h, n, d)).astype(np.float32)
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    key_mask = torch.tensor(mask) if with_mask else None
    qr, kr, kbias = fa.flash_prepass_plain(tq, tk, key_mask, (torch.tensor(cos), torch.tensor(sin)), 128)
    s = torch.matmul(qr[:, :n].float(), kr[:, :n].float().transpose(-1, -2)).view(b, h, n, n) * 0.125
    if kbias is not None:
        s = s + kbias[:, None, None, :n]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    got = (torch.matmul(p.to(torch.bfloat16).float(), tv.float()) / p.sum(dim=-1, keepdim=True)).to(torch.bfloat16)
    bf = jnp.bfloat16
    ref = jax_flash(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf), 0.125,
                    jnp.asarray(mask) if with_mask else None, rope=(jnp.asarray(cos), jnp.asarray(sin)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=1e-2, rtol=0)


def test_core_scratch_is_one_buffer_laid_out_for_the_kernel():
    """The wrapper's single allocation for the pre-pass: the rotated halves
    (bf16 [2, b h, n_pad, d]), then the key biases (float32 [b, n_pad]) on
    a 16-byte boundary; pointers only for what the pre-pass writes."""
    b, h, n_pad, d = 2, 3, 256, 64
    buf, rot, kbias = fa._core_scratch(b, h, n_pad, d, True, True, "cpu")
    assert buf.numel() == 2 * b * h * n_pad * d * 2 + b * n_pad * 4
    assert rot == buf.data_ptr() and kbias - rot == 2 * b * h * n_pad * d * 2 and kbias % 16 == rot % 16
    buf, rot, kbias = fa._core_scratch(b, h, n_pad, d, False, True, "cpu")
    assert rot is None and kbias == buf.data_ptr() and buf.numel() == b * n_pad * 4
    assert fa._core_scratch(b, h, n_pad, d, False, False, "cpu") == (None, None, None)
