"""The CUDA kernels against their plain versions on an NVIDIA GPU: the
attention forward (K1) and backward (K2), bf16 and float32, the
dequantizing matmul, and the probe tools' kernels (the attention variants
P1-P4 and the Triton LayerNorm + modulate P5).

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, absolute on O(1) outputs: 2e-2 in bf16 (attention: both sides
round P and the rotated q and k to bf16 at different points; matmul: both
round W to bf16, and they sum in another order and round the output); 1e-4
in float32 (the same float32 math summed in another order). TF32 is off.
Attention gradients are held relative to the plain gradient's largest
magnitude, floored at 0.1 (at n = 1, dq and dk are a cancellation, 0 in
exact arithmetic): 2e-2 in bf16 (P and dS rounded to bf16 on both sides, at
different points), 1e-4 in float32. LayerNorm + modulate: 1e-2 + 8e-3 times
the plain output's magnitude in bf16 (one bf16 rounding of the output, whose
ulp grows with it), 1e-4 in float32.
"""

import pytest
import torch

from f5_tts_tpu_torch.models.quant import quantize_kernel
from f5_tts_tpu_torch.models.rope import rotary_freqs
from f5_tts_tpu_torch.ops import flash_attention as fa
from f5_tts_tpu_torch.ops.flash_attention import (
    attention_lse_plain,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from f5_tts_tpu_torch.ops import attn_variants as av
from f5_tts_tpu_torch.ops.ln_modulate import ln_modulate, ln_modulate_plain
from f5_tts_tpu_torch.ops.qmatmul import qmatmul, qmatmul_plain

TOL = 2e-2
TOL_F32 = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, b, h, n, d):
    return [torch.randn(b, h, n, d, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3)]


def _rope(n, d):
    raw = rotary_freqs(n, d, device="cuda")
    return torch.cos(raw), torch.sin(raw)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("n", [1, 37, 64, 130])
def test_kernel_matches_plain(gen, d, n):
    q, k, v = _qkv(gen, 2, 3, n, d)
    mask = torch.arange(n, device="cuda")[None, :] < torch.tensor([[max(n - 5, 1)], [n]], device="cuda")
    for key_mask, rope in ((None, None), (mask, None), (None, _rope(n, d)), (mask, _rope(n, d))):
        before = flash_attention.launches
        out = flash_attention(q, k, v, d ** -0.5, key_mask=key_mask, rope=rope)
        assert flash_attention.launches == before + 1
        ref = flash_attention_plain(q, k, v, d ** -0.5, key_mask, rope)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=0)


@pytest.mark.cuda
def test_fully_masked_rows_average_uniformly(gen):
    q, k, v = _qkv(gen, 2, 2, 100, 64)
    mask = torch.zeros(2, 100, dtype=torch.bool, device="cuda")
    mask[1, :3] = True
    out = flash_attention(q, k, v, 0.125, key_mask=mask, rope=_rope(100, 64))
    assert torch.isfinite(out).all()
    uniform = v[0].float().mean(dim=1, keepdim=True).expand(-1, 100, -1)
    torch.testing.assert_close(out[0].float(), uniform, atol=TOL, rtol=0)
    ref = flash_attention_plain(q, k, v, 0.125, mask, _rope(100, 64))
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=0)


@pytest.mark.cuda
def test_strided_projection_views(gen):
    """q, k, v viewed from [b, n, h*d] projections; the output keeps q's
    strides so it reshapes back without a copy."""
    b, n, h, d = 2, 200, 4, 64
    x = [torch.randn(b, n, h * d, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3)]
    q, k, v = (t.view(b, n, h, d).transpose(1, 2) for t in x)
    out = flash_attention(q, k, v, 0.125, rope=_rope(n, d))
    assert out.stride() == q.stride()
    ref = flash_attention_plain(q, k, v, 0.125, None, _rope(n, d))
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=0)
    out.transpose(1, 2).view(b, n, h * d)  # no copy needed


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("n", [1, 37, 130])
def test_f32_kernel_matches_plain(gen, d, n):
    """The float32 kernel, with the mask and RoPE combinations, including a
    row whose keys are all masked."""
    q, k, v = (x.float() for x in _qkv(gen, 2, 3, n, d))
    mask = torch.arange(n, device="cuda")[None, :] < torch.tensor([[max(n - 5, 1)], [n]], device="cuda")
    none = torch.zeros(2, n, dtype=torch.bool, device="cuda")
    none[1] = True
    for key_mask, rope in ((None, None), (mask, None), (None, _rope(n, d)), (mask, _rope(n, d)), (none, _rope(n, d))):
        before = flash_attention.launches_f32
        out = flash_attention(q, k, v, d ** -0.5, key_mask=key_mask, rope=rope)
        assert flash_attention.launches_f32 == before + 1
        ref = flash_attention_plain(q, k, v, d ** -0.5, key_mask, rope)
        assert out.shape == q.shape and out.dtype == torch.float32 and torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, atol=TOL_F32, rtol=0)


@pytest.mark.cuda
def test_rejects_what_the_kernel_does_not_take(gen):
    q, k, v = _qkv(gen, 1, 2, 16, 64)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash_attention(q.half(), k.half(), v.half(), 0.125)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash_attention(q, k.float(), v, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32], k[..., :32], v[..., :32], 0.125)
    with pytest.raises(ValueError, match="key_mask"):
        flash_attention(q, k, v, 0.125, key_mask=torch.ones(1, 16, device="cuda"))
    with pytest.raises(ValueError, match="rope"):
        flash_attention(q, k, v, 0.125, rope=tuple(t.to(torch.bfloat16) for t in _rope(16, 64)))
    qt = torch.randn(1, 2, 64, 16, generator=gen, device="cuda", dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="strides"):
        flash_attention(qt, k, v, 0.125)


# ------------------------------------------------------------ attention backward

GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _grads_vs_plain(gen, b, h, n, d, dtype, key_mask, rope, strided):
    """K2's dq, dk, dv (through autograd of flash_attention) and the plain
    backward's, on the same inputs and output gradient."""
    if strided:
        x = [torch.randn(b, n, h * d, generator=gen, device="cuda").to(dtype) for _ in range(4)]
        q, k, v, g = (t.view(b, n, h, d).transpose(1, 2) for t in x)
    else:
        q, k, v, g = (torch.randn(b, h, n, d, generator=gen, device="cuda").to(dtype) for _ in range(4))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (flash_attention.launches_bwd, flash_attention.launches_bwd_f32)
    out = flash_attention(*leaves, d ** -0.5, key_mask=key_mask, rope=rope)
    got = torch.autograd.grad(out, leaves, g)
    after = (flash_attention.launches_bwd, flash_attention.launches_bwd_f32)
    assert after[dtype == torch.float32] == before[dtype == torch.float32] + 1
    ref = flash_attention_bwd_plain(q, k, v, out.detach(), g, d ** -0.5, key_mask, rope)
    return got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("n", [1, 37, 64, 130])
def test_bwd_kernel_matches_plain(gen, dtype, d, n):
    mask = torch.arange(n, device="cuda")[None, :] < torch.tensor([[max(n - 5, 1)], [n]], device="cuda")
    for key_mask, rope in ((None, None), (mask, None), (None, _rope(n, d)), (mask, _rope(n, d))):
        got, ref = _grads_vs_plain(gen, 2, 3, n, d, dtype, key_mask, rope, strided=n == 130)
        for name, a, r in zip("qkv", got, ref):
            assert a.dtype == dtype and a.shape == r.shape and torch.isfinite(a).all()
            err = (a.float() - r).abs().max().item() / max(r.abs().max().item(), 0.1)
            assert err <= GRAD_TOL[dtype], (f"d{name}", key_mask is not None, rope is not None, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_bwd_kernel_training_shape_strided(gen, dtype):
    """The DiT's shape: q, k, v and g as [b, n, h*d] projection views, RoPE,
    no mask, 1024 frames."""
    got, ref = _grads_vs_plain(gen, 2, 16, 1024, 64, dtype, None, _rope(1024, 64), strided=True)
    for a, r in zip(got, ref):
        assert (a.float() - r).abs().max().item() <= GRAD_TOL[dtype] * r.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_autograd_function_agrees_with_autograd_of_plain(gen, dtype):
    """gradcheck-style: the gradient of a scalar function of the output,
    through FlashAttentionFn (K1 + K2), against autograd through
    flash_attention_plain."""
    b, h, n, d = 2, 4, 100, 64
    base = [torch.randn(b, h, n, d, generator=gen, device="cuda").to(dtype) for _ in range(3)]
    w = torch.randn(b, h, n, d, generator=gen, device="cuda")
    mask = torch.arange(n, device="cuda")[None, :] < torch.tensor([[70], [n]], device="cuda")
    grads = []
    for fn in (flash_attention, flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in base]
        out = fn(*leaves, 0.125, mask, _rope(n, d))
        grads.append(torch.autograd.grad((out.float() * w).sum(), leaves))
    for a, r in zip(*grads):
        r = r.float()
        assert (a.float() - r).abs().max().item() <= GRAD_TOL[dtype] * r.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_forward_lse_matches_plain(gen, dtype):
    """K1's log-sum-exp output (rows with a kept key; a fully masked row is
    -1e30 in the kernel and the float32 minimum in the plain version)."""
    b, h, n, d = 2, 3, 130, 64
    q, k, v = (x.to(dtype) for x in _qkv(gen, b, h, n, d))
    mask = torch.arange(n, device="cuda")[None, :] < torch.tensor([[90], [n]], device="cuda")
    rope = _rope(n, d)
    key_mask, cos, sin = fa._checked(q, k, v, mask, rope)
    out, lse = fa._forward_kernel(q, k, v, 0.125, key_mask, cos, sin, with_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, n) and lse.dtype == torch.float32
    ref = attention_lse_plain(q, k, 0.125, mask, rope)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(lse, ref, atol=tol, rtol=0)
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v, 0.125, mask, rope).float(),
                               atol=TOL if dtype == torch.bfloat16 else TOL_F32, rtol=0)


@pytest.mark.cuda
def test_no_grad_launches_no_backward_and_no_lse(gen, monkeypatch):
    q, k, v = _qkv(gen, 1, 2, 64, 64)
    calls = []
    real = fa._forward_kernel
    monkeypatch.setattr(fa, "_forward_kernel", lambda *a, **kw: calls.append(kw["with_lse"]) or real(*a, **kw))
    before = (flash_attention.launches, flash_attention.launches_bwd)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        out = flash_attention(*leaves, 0.125, rope=_rope(64, 64))
    assert out.grad_fn is None and calls == [False]
    assert (flash_attention.launches, flash_attention.launches_bwd) == (before[0] + 1, before[1])
    out = flash_attention(*leaves, 0.125, rope=_rope(64, 64))
    assert calls == [False, True]
    out.float().sum().backward()
    assert flash_attention.launches_bwd == before[1] + 1


@pytest.mark.cuda
def test_bwd_rejects_what_the_kernel_does_not_take(gen):
    q, k, v = (t.requires_grad_() for t in _qkv(gen, 1, 2, 16, 64))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        flash_attention(q.half(), k.half(), v.half(), 0.125)
    key_mask, cos, sin = fa._checked(q, k, v, None, None)
    out, lse = fa._forward_kernel(q.detach(), k.detach(), v.detach(), 0.125, key_mask, cos, sin, with_lse=True)
    with pytest.raises(ValueError, match="gradient"):
        fa._backward_kernel(q, k, v, out, lse, out.float(), 0.125, key_mask, cos, sin)
    # a gradient whose head dim is not contiguous is copied, not refused
    g = torch.randn(1, 2, 64, 16, generator=gen, device="cuda").to(torch.bfloat16).transpose(2, 3)
    dq, dk, dv = fa._backward_kernel(q, k, v, out, lse, g, 0.125, key_mask, cos, sin)
    ref = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out, g, 0.125)
    for a, r in zip((dq, dk, dv), ref):
        assert (a - r).abs().max().item() <= GRAD_TOL[torch.bfloat16] * r.abs().max().item()


# ------------------------------------------------------------ dequantizing matmul


def _quantized(gen, n, k, bits):
    """Weights drawn as the model's linears are, U(-1/sqrt(k), 1/sqrt(k)), so
    outputs stay O(1) (below 4, where a bf16 ulp is 1/32)."""
    w = (torch.rand(k, n, generator=gen, device="cuda") * 2 - 1) / k ** 0.5
    p = quantize_kernel(w.cpu().numpy(), bits)
    return [torch.from_numpy(p[name].T.copy()).cuda() for name in ("q", "scales", "biases")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [100, 1024])
@pytest.mark.parametrize("m", [1, 31, 130, 2048])
def test_qmatmul_matches_plain(gen, m, n, bits, dtype):
    """Scales and biases in the activations' dtype, as a model cast to bf16
    holds them, with and without the linear's bias."""
    k = 1024
    q, scales, biases = _quantized(gen, n, k, bits)
    scales, biases = scales.to(dtype), biases.to(dtype)
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(dtype)
    for b in (None, bias):
        before = qmatmul.launches
        out = qmatmul(x, q, scales, biases, b)
        assert qmatmul.launches == before + 1
        ref = qmatmul_plain(x, q, scales, biases, b)
        assert out.shape == (m, n) and out.dtype == dtype
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL if dtype == torch.bfloat16 else TOL_F32, rtol=0)


@pytest.mark.cuda
def test_qmatmul_leading_dims_strided_input_and_f32_scales(gen):
    q, scales, biases = _quantized(gen, 192, 256, 4)
    x = torch.randn(2, 256, 40, generator=gen, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
    out = qmatmul(x, q, scales, biases)  # float32 scales with bf16 activations
    assert out.shape == (2, 40, 192)
    torch.testing.assert_close(out.float(), qmatmul_plain(x, q, scales, biases).float(), atol=TOL, rtol=0)


@pytest.mark.cuda
def test_qmatmul_rejects_what_the_kernel_does_not_take(gen):
    q, scales, biases = _quantized(gen, 64, 128, 8)
    x = torch.randn(4, 128, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="multiple of 64"):
        qmatmul(x[:, :96], q[:, :96], scales[:, :1], biases[:, :1])
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        qmatmul(x.half(), q, scales, biases)
    with pytest.raises(ValueError, match="int8"):
        qmatmul(x, q.to(torch.int16), scales, biases)
    with pytest.raises(ValueError, match="scales"):
        qmatmul(x, q, scales.half(), biases)


# ------------------------------------------------------------ probe kernels P1-P5


def _rope_inputs(n, d):
    from f5_tts_tpu_torch.tools.fusion_probe import perm_matrix

    cos, sin = _rope(n, d)
    return cos, sin, torch.tensor(perm_matrix(d), device="cuda")


def _variant(name, q, k, v, scale, rope):
    """The wrapper's output, its launch count's step, and the plain output."""
    fn = getattr(av, name)
    args = (q, k, v) if rope is None else (q, k, v, *rope)
    before = fn.launches
    out = fn(*args, scale)
    assert fn.launches == before + 1
    plain = {"attn_pack2": av.attention_plain, "attn_flat": av.attention_plain,
             "flash_bhnd_rope": av.flash_bhnd_rope_plain, "flash_nhd": av.flash_nhd_plain}[name]
    return out, plain(*args, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["attn_pack2", "attn_flat", "flash_bhnd_rope", "flash_nhd"])
@pytest.mark.parametrize("shape", [(2, 16, 1024, 64), (2, 16, 1000, 64), (1, 3, 37, 128), (2, 2, 130, 128)],
                         ids=["main", "ragged", "odd-heads", "d128"])
def test_attn_variant_matches_plain(gen, name, shape):
    b, h, n, d = shape
    nhd = name == "flash_nhd"
    q, k, v = (torch.randn(*((b, n, h, d) if nhd else shape), generator=gen, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    rope = _rope_inputs(n, d) if name.startswith("flash") else None
    out, ref = _variant(name, q, k, v, d ** -0.5, rope)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=0)


@pytest.mark.cuda
def test_flash_nhd_reads_a_non_contiguous_view(gen):
    """q, k, v as [b, n, h, d] views of one fused [b, n, 3, h, d] projection,
    with a random P; the output is written in q's layout."""
    b, n, h, d = 2, 300, 4, 64
    qkv = torch.randn(b, n, 3, h, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    cos, sin = _rope(n, d)
    P = torch.randn(d, d, generator=gen, device="cuda") / d ** 0.5
    out, ref = _variant("flash_nhd", q, k, v, 0.125, (cos, sin, P))
    assert out.shape == (b, n, h, d)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["attn_pack2", "attn_flat", "flash_bhnd_rope", "flash_nhd"])
def test_attn_variant_rejects_what_the_kernel_does_not_take(gen, name):
    for dtype, d, match in ((torch.float32, 64, "bfloat16"), (torch.bfloat16, 96, "head dim")):
        q, k, v = (torch.randn(1, 2, 16, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
        rope = _rope_inputs(16, d) if name.startswith("flash") else None
        args = (q, k, v) if rope is None else (q, k, v, *rope)
        with pytest.raises(ValueError, match=match):
            getattr(av, name)(*args, 0.125)


def _ln_inputs(gen, b, n, d, dtype):
    x = torch.randn(b, n, d, generator=gen, device="cuda").to(dtype) * 2 + 0.5
    return x, *(torch.randn(b, d, generator=gen, device="cuda").to(dtype) for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 1024, 1024), (2, 1000, 1024), (3, 7, 100)], ids=["main", "ragged", "small"])
def test_ln_modulate_matches_plain(gen, shape, dtype):
    x, scale, shift = _ln_inputs(gen, *shape, dtype)
    before = ln_modulate.launches
    out = ln_modulate(x, scale, shift)
    assert ln_modulate.launches == before + 1
    ref = ln_modulate_plain(x, scale, shift)
    torch.cuda.synchronize()
    assert out.shape == x.shape and out.dtype == dtype
    err = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        assert (err <= 1e-2 + 8e-3 * ref.float().abs()).all(), err.max().item()
    else:
        assert err.max().item() <= TOL_F32


@pytest.mark.cuda
def test_ln_modulate_strided_input_and_rejections(gen):
    x, scale, shift = _ln_inputs(gen, 2, 64, 256, torch.bfloat16)
    xs = x[:, ::2]  # every other row: a row stride the kernel reads as given
    out = ln_modulate(xs, scale, shift)
    ref = ln_modulate_plain(xs, scale, shift)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 + 8e-3 * ref.float().abs().max().item()
    with pytest.raises(ValueError, match="scale"):
        ln_modulate(x, scale[:, :128], shift)
    with pytest.raises(ValueError, match=r"\[b, n, d\]"):
        ln_modulate(x[0], scale, shift)
