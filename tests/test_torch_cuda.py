"""The CUDA kernels against their plain versions on an NVIDIA GPU: the
attention forward (K1; in bf16 at d = 64 and 128 a rotation pre-pass held
bit for bit and the TMA + wgmma core) and backward (K2), bf16 and float32
(at d = 64 on the tensor cores in 3xTF32, held to the float32 tolerance all
the same), the
dequantizing matmul (its float32 kernel in 3xTF32 too), and the probe
tools' kernels (the attention variants P1-P4, with the RoPE pre-pass of P3
and P4 held exactly or within an ulp, and the Triton LayerNorm + modulate
P5), and the W8A8 linear's Triton kernels (`quantize_rows`,
`rescale_bias`) bit for bit against their plain versions; the registered
operators that carry K1, K3 and the W8A8 kernels into exported programs
launch them, and a program exported on the CPU launches K1 once moved to
the card, also over a data-2 grid of the card, each data row to the bit
against its share; for mesh inference, K1 on one slot's heads of strided local
projections, K3 and K3-f32 at the shard shapes of a model axis of 2, the
W8A8 row-parallel kernels (`row_absmax`, `quantize_scaled`) bit for bit,
and a W8A8 DiT split over two slots equal to the unsharded one to the bit;
the ISTFT on the card, whatever the batch, against the CPU's; for training
over a mesh, K1 with its log-sum-exp and K2 at a 2 x 2 slot's shape on
strided projections (bf16 [2, 8, 1024, 64], float32 [2, 4, 1024, 64]), and
one sharded step of a float32 DiT over 2 x 2 slots of the card against the
unsharded step (within 2e-5, the JAX suite's sharded-step tolerance).

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
from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb, rotary_freqs
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
from f5_tts_tpu_torch.ops import w8a8 as w8

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


# ------------------------------------------------------------ float32 attention on the tensor cores


def _f32_case(gen, b, h, n, d, key_mask):
    """q, k, v, g float32 as [b, n, h*d] projection views with RoPE: K1-f32's
    output and lse and K2-f32's gradients through the wrappers, each launch
    counted once, and their plain versions."""
    x = [torch.randn(b, n, h * d, generator=gen, device="cuda") for _ in range(4)]
    q, k, v, g = (t.view(b, n, h, d).transpose(1, 2) for t in x)
    rope = _rope(n, d)
    km, cos, sin = fa._checked(q, k, v, key_mask, rope)
    before = (flash_attention.launches, flash_attention.launches_f32, flash_attention.launches_bwd,
              flash_attention.launches_bwd_f32)
    out, lse = fa._forward_kernel(q, k, v, d ** -0.5, km, cos, sin, with_lse=True)
    got = fa._backward_kernel(q, k, v, out, lse, g, d ** -0.5, km, cos, sin)
    after = (flash_attention.launches, flash_attention.launches_f32, flash_attention.launches_bwd,
             flash_attention.launches_bwd_f32)
    assert [a - b for a, b in zip(after, before)] == [0, 1, 0, 1]  # the pre-passes count with their calls
    ref_out = flash_attention_plain(q, k, v, d ** -0.5, key_mask, rope)
    ref = flash_attention_bwd_plain(q, k, v, out, g, d ** -0.5, key_mask, rope)
    torch.cuda.synchronize()
    return (q, k, v, out, lse, g, km, cos, sin), out, ref_out, got, ref


def _check_f32_case(case, key_mask):
    (q, k, _, _, lse, _, _, _, _), out, ref_out, got, ref = case
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref_out, atol=TOL_F32, rtol=0)
    # the lse of rows with a kept key (a fully masked row is -1e30 in the kernel, the float32 minimum in plain)
    kept = torch.ones(q.shape[:3], dtype=torch.bool, device="cuda")
    if key_mask is not None:
        kept = key_mask.any(dim=1)[:, None, None].expand(q.shape[:3])
    ref_lse = attention_lse_plain(q, k, q.shape[-1] ** -0.5, key_mask, _rope(*q.shape[2:]))
    torch.testing.assert_close(lse[kept], ref_lse[kept], atol=TOL_F32, rtol=0)
    for name, a, r in zip("qkv", got, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape and a.is_contiguous() and torch.isfinite(a).all()
        err = (a - r).abs().max().item() / max(r.abs().max().item(), 0.1)
        assert err <= GRAD_TOL[torch.float32], (f"d{name}", err)


@pytest.mark.cuda
def test_f32_duration_training_shape(gen):
    """The duration step's shape: [4, 8, 1024, 64] strided projection views,
    RoPE, no mask; K1-f32 (output and lse) and K2-f32 on the 3xTF32 kernels."""
    _check_f32_case(_f32_case(gen, 4, 8, 1024, 64, None), None)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["none", "ragged", "fully-masked-row"])
@pytest.mark.parametrize("n", [187, 937, 1000])
def test_f32_ragged_n_and_masks(gen, n, mask):
    """Ragged n (the last tile partial), without a mask, with a ragged key
    mask, and with every key of batch 0 masked (uniform rows)."""
    key_mask = None
    if mask != "none":
        key_mask = torch.arange(n, device="cuda")[None, :] < torch.tensor([[n - 61], [n]], device="cuda")
        if mask == "fully-masked-row":
            key_mask[0] = False
    _check_f32_case(_f32_case(gen, 2, 3, n, 64, key_mask), key_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
def test_f32_wide_heads_on_the_fma_kernels(gen, d):
    """d = 128 and 256 keep the FMA kernels (the backward reads the pre-pass's
    row stats), with a ragged mask and a fully masked row."""
    n = 187
    key_mask = torch.arange(n, device="cuda")[None, :] < torch.tensor([[0], [150]], device="cuda")
    _check_f32_case(_f32_case(gen, 2, 2, n, d, key_mask), key_mask)


@pytest.mark.cuda
def test_f32_bwd_is_deterministic(gen):
    """The two warpgroups' partial sums are added in a fixed order: two runs
    give the same bits."""
    args, _, _, first, _ = _f32_case(gen, 2, 4, 1000, 64, None)
    second = fa._backward_kernel(*args[:6], 64 ** -0.5, *args[6:])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
    counter = "launches" if dtype == torch.bfloat16 else "launches_f32"
    for b in (None, bias):
        before = (qmatmul.launches, qmatmul.launches_f32)
        out = qmatmul(x, q, scales, biases, b)
        after = (qmatmul.launches, qmatmul.launches_f32)
        assert after[counter == "launches_f32"] == before[counter == "launches_f32"] + 1
        assert after[counter == "launches"] == before[counter == "launches"]
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


# the quantized linears of the main path, (m, k, n): time conditioning (m = 31), the text branch, the DiT blocks
QMM_SHAPES = [(31, 256, 1024), (31, 1024, 1024), (31, 1024, 6144), (31, 1024, 2048), (1024, 512, 1024),
              (1024, 1024, 512), (2048, 1024, 1024), (2048, 1024, 2048), (2048, 2048, 1024), (2048, 1024, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32], ids=["bf16-scales", "f32-scales"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", QMM_SHAPES, ids=[f"{m}x{k}x{n}" for m, k, n in QMM_SHAPES])
def test_qmatmul_f32_main_path_shapes(gen, shape, bits, scale_dtype):
    """The float32 kernel (3xTF32 wgmma) at every quantized linear shape of
    the main path, each plan of `plan_f32` among them, with the linear's
    bias: one launch counted, held to the plain version at the float32
    tolerance."""
    m, k, n = shape
    q, scales, biases = _quantized(gen, n, k, bits)
    scales, biases = scales.to(scale_dtype), biases.to(scale_dtype)
    x = torch.randn(m, k, generator=gen, device="cuda")
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    before = qmatmul.launches_f32
    out = qmatmul(x, q, scales, biases, bias)
    assert qmatmul.launches_f32 == before + 1
    ref = qmatmul_plain(x, q, scales, biases, bias)
    assert out.shape == (m, n) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=TOL_F32, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [31, 2048])
def test_qmatmul_f32_is_deterministic(gen, m):
    """Two calls give the same bits: no atomics, and no stage or lo tile is
    written while a warpgroup's products still read it."""
    q, scales, biases = _quantized(gen, 1024, 1024, 4)
    x = torch.randn(m, 1024, generator=gen, device="cuda")
    assert torch.equal(qmatmul(x, q, scales, biases), qmatmul(x, q, scales, biases))


@pytest.mark.cuda
def test_qmatmul_f32_x_map_is_kept_apart_from_bf16(gen):
    """A float32 x at an address where a bf16 x of the same shape was mapped
    gets a float32 tensor map of its own (the float32 maps are cached
    apart), and the right result."""
    from f5_tts_tpu_torch.ops import qmatmul as qm

    q, s, b = _quantized(gen, 256, 512, 4)
    m, k = 45, 512  # an m no other test uses
    buf = torch.empty(m, k, device="cuda")
    x16 = buf.view(-1).view(torch.bfloat16)[: m * k].view(m, k)
    assert x16.data_ptr() == buf.data_ptr()
    x16.copy_(torch.randn(m, k, generator=gen, device="cuda"))
    s16, b16 = s.to(torch.bfloat16), b.to(torch.bfloat16)
    torch.testing.assert_close(qmatmul(x16, q, s16, b16).float(), qmatmul_plain(x16, q, s16, b16).float(),
                               atol=TOL, rtol=0)
    before = qm.maps_encoded()
    buf.copy_(torch.randn(m, k, generator=gen, device="cuda"))
    torch.testing.assert_close(qmatmul(buf, q, s, b), qmatmul_plain(buf, q, s, b), atol=TOL_F32, rtol=0)
    after = qm.maps_encoded()
    assert after["x_f32"] == before["x_f32"] + 1 and after["x"] == before["x"]


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
    _check_variant(gen, name, shape)


def _check_variant(gen, name, shape):
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
@pytest.mark.parametrize("name", ["flash_bhnd_rope", "flash_nhd"])
@pytest.mark.parametrize("shape", [(1, 3, 129, 64), (3, 5, 255, 64), (1, 4, 4096, 64), (2, 3, 1000, 128),
                                   (1, 5, 127, 128)],
                         ids=["n%128=1", "n%128=127", "n=4096", "d128", "d128-n%128=127"])
def test_rope_attention_edges(gen, name, shape):
    """The RoPE kernels (pre-pass, then the TMA + wgmma forward) at ragged
    n (a last 128-row block of one row or of 127, odd b * h), at n = 4096
    (64 key tiles through the ring) and at d = 128 (two swizzled panels a
    tile), in both layouts."""
    _check_variant(gen, name, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_bhnd_rope", "flash_nhd"])
@pytest.mark.parametrize("d", [64, 128])
def test_rope_attention_is_deterministic(gen, name, d):
    """Two calls give the same bits: no atomics, and no stage of the ring is
    refilled while a warp still reads it."""
    shape = (2, 1000, 16, d) if name == "flash_nhd" else (2, 16, 1000, d)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    args = (q, k, v, *_rope_inputs(1000, d), d ** -0.5)
    first = getattr(av, name)(*args)
    for _ in range(3):
        assert torch.equal(getattr(av, name)(*args), first)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 130, 1000, 4096])
def test_attn_pack2_core_edges(gen, n):
    """P1 on the TMA + wgmma core: ragged n (q and k rows past n arrive as
    TMA's zero fill), d = 128 (two swizzled panels a tile), odd b * h = 3,
    q and k as [b, h, n, d] views of [b, n, h, d] data, and v expanded over
    the heads (a zero stride, copied before its tensor map is built)."""
    b, h, d = 1, 3, 128
    q, k = (torch.randn(b, n, h, d, generator=gen, device="cuda", dtype=torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    v = torch.randn(b, n, 1, d, generator=gen, device="cuda", dtype=torch.bfloat16).transpose(1, 2).expand(b, h, n, d)
    assert v.stride()[1] == 0 and (n == 1 or not q.is_contiguous())  # at n = 1 the view is contiguous
    out, ref = _variant("attn_pack2", q, k, v, d ** -0.5, None)
    torch.cuda.synchronize()
    assert out.shape == (b, h, n, d) and out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_attn_pack2_is_deterministic(gen, d):
    """Four calls give the same bits: no atomics, and no stage of the ring is
    refilled while a warp still reads it."""
    q, k, v = _qkv(gen, 2, 16, 1000, d)
    first = av.attn_pack2(q, k, v, d ** -0.5)
    for _ in range(3):
        assert torch.equal(av.attn_pack2(q, k, v, d ** -0.5), first)


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().float().clamp_min(torch.finfo(torch.float32).tiny))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("perm", ["pair swap", "random"])
@pytest.mark.parametrize("layout", ["bhnd", "nhd"])
def test_rope_prepass_matches_plain(gen, layout, perm, d):
    """The pre-pass kernel's scratch against `rope_prepass_plain`: equal for
    the pair swap; for a random P within one bf16 ulp of the result or of its
    larger term (bf16(x @ P) of float32 sums in another order may round the
    other way); rows n to n_pad zero."""
    b, h, n, n_pad = 2, 3, 300, 384
    shape = (b, n, h, d) if layout == "nhd" else (b, h, n, d)
    q, k = (torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(2))
    if layout == "nhd":
        q, k = q.transpose(1, 2), k.transpose(1, 2)
    cos, sin, P = _rope_inputs(n, d)
    if perm == "random":
        P = torch.randn(d, d, generator=gen, device="cuda") / d ** 0.5
    before = av.rope_prepass.launches
    got = av.rope_prepass(q, k, cos, sin, P, n_pad)
    assert av.rope_prepass.launches == before + 1
    ref = av.rope_prepass_plain(q, k, cos, sin, P, n_pad)
    torch.cuda.synchronize()
    for x, g, r in zip((q, k), got, ref):
        assert g.shape == (b * h, n_pad, d) and g.dtype == torch.bfloat16
        assert not g[:, n:].any()
        if perm == "pair swap":
            assert torch.equal(g, r)
            continue
        c, s, Pb = (t.to(torch.bfloat16) for t in (cos, sin, P))
        terms = [(x * c).reshape(b * h, n, d),
                 (torch.matmul(x.float(), Pb.float()).to(torch.bfloat16) * s).reshape(b * h, n, d)]
        big = torch.maximum(terms[0].abs(), terms[1].abs())
        tol = torch.maximum(_bf16_ulp(r[:, :n]), _bf16_ulp(big))
        assert ((g[:, :n].float() - r[:, :n].float()).abs() <= tol).all()


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


# ------------------------------------------------------------ the redesigned K2 and K3 (TMA + wgmma)


def _bwd_case(gen, b, h, n, d, key_mask=None):
    """q, k, v, g as [b, n, h*d] projection views with RoPE; returns the
    inputs, K2's (dq, dk, dv) through the wrapper, and the plain gradients."""
    x = [torch.randn(b, n, h * d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4)]
    q, k, v, g = (t.view(b, n, h, d).transpose(1, 2) for t in x)
    rope = _rope(n, d)
    key_mask_k, cos, sin = fa._checked(q, k, v, key_mask, rope)
    out, lse = fa._forward_kernel(q, k, v, d ** -0.5, key_mask_k, cos, sin, with_lse=True)
    before = flash_attention.launches_bwd
    got = fa._backward_kernel(q, k, v, out, lse, g, d ** -0.5, key_mask_k, cos, sin)
    assert flash_attention.launches_bwd == before + 1  # one count per backward call, pre-pass included
    ref = flash_attention_bwd_plain(q, k, v, out, g, d ** -0.5, key_mask, rope)
    return (q, k, v, out, lse, g, key_mask_k, cos, sin), got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("n", [1, 63, 937, 1024, 4096])
def test_bwd_bf16_edges(gen, d, n):
    """Every head dim (d = 256 on the mma.sync kernels, 64 and 128 on wgmma),
    ragged and long n, strided views, RoPE; bf16 gradients within GRAD_TOL
    of the plain float32 ones, relative to their largest magnitude."""
    b, h = (1, 2) if n == 4096 else (2, 3)
    _, got, ref = _bwd_case(gen, b, h, n, d)
    torch.cuda.synchronize()
    for name, a, r in zip("qkv", got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape and a.is_contiguous() and torch.isfinite(a).all()
        err = (a.float() - r).abs().max().item() / max(r.abs().max().item(), 0.1)
        assert err <= GRAD_TOL[torch.bfloat16], (f"d{name}", err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_bwd_bf16_fully_masked_rows(gen, d):
    """A key mask that leaves batch 0 no key: those rows' P is uniform over
    the n keys in K1 and K2 alike; batch 1 keeps a ragged run of keys."""
    n = 150
    mask = torch.zeros(2, n, dtype=torch.bool, device="cuda")
    mask[1, :97] = True
    _, got, ref = _bwd_case(gen, 2, 2, n, d, key_mask=mask)
    for a, r in zip(got, ref):
        assert torch.isfinite(a).all()
        assert (a.float() - r).abs().max().item() <= GRAD_TOL[torch.bfloat16] * max(r.abs().max().item(), 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_bwd_bf16_dv_is_the_float32_sum_rounded_once(gen, d):
    """With every key masked, P = 1/n exactly (n a power of two), so dV is
    sum_q g / n, exact in float32 for small integer g; the kernel's bf16 dv
    must be that sum rounded once to nearest-even (the integers are chosen
    so that many sums need rounding)."""
    b, h, n = 1, 2, 64
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    g = torch.randint(-100, 101, (b, h, n, d), generator=gen, device="cuda").to(torch.bfloat16)
    mask = torch.zeros(b, n, dtype=torch.bool, device="cuda")
    key_mask, cos, sin = fa._checked(q, k, v, mask, None)
    out, lse = fa._forward_kernel(q, k, v, 0.125, key_mask, cos, sin, with_lse=True)
    dv = fa._backward_kernel(q, k, v, out, lse, g, 0.125, key_mask, cos, sin)[2]
    exact = g.double().sum(dim=2, keepdim=True).expand(-1, -1, n, -1) / n
    assert (exact.float().double() == exact).all()  # the float32 sum is exact
    assert not (exact.to(torch.bfloat16).double() == exact).all()  # and bf16 has to round it
    assert torch.equal(dv, exact.float().to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_bwd_bf16_is_deterministic(gen, d):
    """No atomics: two runs on the same inputs give the same bits."""
    args, first, _ = _bwd_case(gen, 2, 4, 300, d)
    second = fa._backward_kernel(*args[:6], d ** -0.5, *args[6:])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32], ids=["bf16-scales", "f32-scales"])
@pytest.mark.parametrize("n", [100, 1024, 6144])
@pytest.mark.parametrize("m", [1, 31, 2048, 2049])
def test_qmatmul_wgmma_edges(gen, monkeypatch, m, n, scale_dtype):
    """The bf16 kernel at every token tile of its launch plan (32, 64, 128)
    and ragged m and n, int4 codes, with the linear's bias."""
    k = 1024
    q, scales, biases = _quantized(gen, n, k, 4)
    scales, biases = scales.to(scale_dtype), biases.to(scale_dtype)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    out = qmatmul(x, q, scales, biases, bias)
    # the plain matmul sums in float32 too (cuBLAS may otherwise reduce split-k partials in bf16)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction", False)
    ref = qmatmul_plain(x, q, scales, biases, bias)
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=0)


@pytest.mark.cuda
def test_qmatmul_codes_map_follows_the_buffer(gen):
    """The codes' tensor map is cached by address and shape: a swapped buffer
    gets its own map, and codes rewritten in place are read anew."""
    from f5_tts_tpu_torch.ops import qmatmul as qm

    def encoded():
        return qm.maps_encoded()["codes"]

    q1, s, b = _quantized(gen, 256, 512, 4)
    q2 = _quantized(gen, 256, 512, 4)[0]
    x = torch.randn(40, 512, generator=gen, device="cuda").to(torch.bfloat16)
    s, b = s.to(torch.bfloat16), b.to(torch.bfloat16)
    torch.testing.assert_close(qmatmul(x, q1, s, b).float(), qmatmul_plain(x, q1, s, b).float(), atol=TOL, rtol=0)
    before = encoded()
    torch.testing.assert_close(qmatmul(x, q1, s, b).float(), qmatmul_plain(x, q1, s, b).float(), atol=TOL, rtol=0)
    assert encoded() == before  # the same buffer reuses its map
    torch.testing.assert_close(qmatmul(x, q2, s, b).float(), qmatmul_plain(x, q2, s, b).float(), atol=TOL, rtol=0)
    assert encoded() == before + 1  # a new map for the new buffer
    q1.copy_(q2)  # same address and shape: the kept map stays right
    torch.testing.assert_close(qmatmul(x, q1, s, b).float(), qmatmul_plain(x, q2, s, b).float(), atol=TOL, rtol=0)
    assert encoded() == before + 1
    half = q1.view(-1)[: 128 * 512].view(128, 512)  # same address, another shape: its own map
    torch.testing.assert_close(qmatmul(x, half, s[:128], b[:128]).float(),
                               qmatmul_plain(x, half, s[:128], b[:128]).float(), atol=TOL, rtol=0)
    assert encoded() == before + 2


@pytest.mark.cuda
def test_qmatmul_x_map_follows_the_buffer(gen):
    """x's tensor map is cached by address and shape: the same buffer reuses
    it, another buffer or the same address with another m gets its own, and
    values rewritten in place are read anew."""
    from f5_tts_tpu_torch.ops import qmatmul as qm

    q, s, b = _quantized(gen, 256, 512, 4)
    s, b = s.to(torch.bfloat16), b.to(torch.bfloat16)
    # an m no other test uses, so no earlier test's buffer left a map at these addresses
    x1, x2 = (torch.randn(43, 512, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))

    def check(x):
        torch.testing.assert_close(qmatmul(x, q, s, b).float(), qmatmul_plain(x, q, s, b).float(), atol=TOL, rtol=0)

    check(x1)
    before = qm.maps_encoded()["x"]
    check(x1)
    assert qm.maps_encoded()["x"] == before  # the same buffer reuses its map
    check(x2)
    assert qm.maps_encoded()["x"] == before + 1  # a new map for the new buffer
    x1.copy_(x2)  # same address and shape: the kept map stays right
    check(x1)
    assert qm.maps_encoded()["x"] == before + 1
    check(x1[:21])  # same address, another m: its own map
    assert qm.maps_encoded()["x"] == before + 2


@pytest.mark.cuda
def test_qmatmul_unaligned_x_is_copied(gen):
    """An x that does not start on 16 bytes is copied before the launch."""
    q, s, b = _quantized(gen, 128, 256, 8)
    flat = torch.randn(33 * 256 + 1, generator=gen, device="cuda").to(torch.bfloat16)
    x = flat[1:].view(33, 256)
    assert x.data_ptr() % 16
    out = qmatmul(x, q, s, b)
    torch.testing.assert_close(out.float(), qmatmul_plain(x, q, s, b).float(), atol=TOL, rtol=0)


# ------------------------------------------------------------ K1 bf16 on the TMA + wgmma core


def _cuda_kernel_names(fn, windows: int = 5):
    """The CUDA kernels `fn` launches, name -> launches, by torch.profiler.
    The profiler drops the event of the first kernel of a window (on the
    H100 the first of `fn`'s three W8A8 kernels was missing from 5 of 5
    windows and the last two never were), so each window first launches
    and waits for a marker (torch's spin kernel, left out of the result);
    and `fn` runs once in each of `windows` windows, each name keeping the
    most launches one window saw: a window cannot invent a launch, and a
    drop in one does not hide one."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    seen = Counter()
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        seen |= Counter(e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name)
    return seen


def _launched(names, part: str) -> int:
    return sum(n for name, n in names.items() if part in name)


def _projection_views(gen, b, h, n, d, count=3):
    """q, k, v (and more) as [b, h, n, d] views of [b, n, h*d] projections."""
    return [torch.randn(b, n, h * d, generator=gen, device="cuda", dtype=torch.bfloat16).view(b, n, h, d).transpose(1, 2)
            for _ in range(count)]


def _valid_mask(b, n, valid):
    return (torch.arange(n, device="cuda") < valid)[None, :].expand(b, n).contiguous()


# (b, h, n, valid keys): the sampling shape with its mask, ragged n, and n = 4096 (32 key tiles through the ring)
K1_CORE_SHAPES = [(2, 16, 1024, 937), (2, 3, 937, 900), (2, 3, 1000, 999), (1, 4, 4096, 4000)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", K1_CORE_SHAPES, ids=["main", "n937", "n1000", "n4096"])
def test_k1_core_matches_plain(gen, shape, d):
    """K1 bf16 on the pre-pass + core against flash_attention_plain, q, k, v
    as projection views, with the mask and RoPE in every combination (a mask
    without RoPE runs the core over q and k in place with the key biases);
    one count a call, and the output in q's strides."""
    b, h, n, valid = shape
    q, k, v = _projection_views(gen, b, h, n, d)
    mask = _valid_mask(b, n, valid)
    for key_mask, rope in ((mask, _rope(n, d)), (None, _rope(n, d)), (mask, None), (None, None)):
        before = flash_attention.launches
        out = flash_attention(q, k, v, d ** -0.5, key_mask=key_mask, rope=rope)
        assert flash_attention.launches == before + 1
        assert out.stride() == q.stride() and out.dtype == torch.bfloat16
        ref = flash_attention_plain(q, k, v, d ** -0.5, key_mask, rope)
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d64-mask-rope", "d64-mask", "d64-rope", "d64", "d128-mask-rope", "d256-mask-rope"])
def test_k1_launches_the_core_and_not_the_old_kernel(gen, case):
    """bf16 at d = 64 and 128 launches the core (after the pre-pass when there
    is a mask or RoPE) and never flash_fwd_kernel; d = 256 keeps
    flash_fwd_kernel."""
    d = int(case.split("-")[0][1:])
    b, h, n = 2, 2, 300
    q, k, v = _qkv(gen, b, h, n, d)
    mask = _valid_mask(b, n, 250) if "mask" in case else None
    rope = _rope(n, d) if "rope" in case else None
    before = flash_attention.launches
    names = _cuda_kernel_names(lambda: flash_attention(q, k, v, d ** -0.5, key_mask=mask, rope=rope))
    assert flash_attention.launches == before + 5  # one count a call, in each of the five windows
    core = _launched(names, "attn_core_fwd_kernel")
    prepass = _launched(names, "flash_fwd_prepass_kernel")
    old = _launched(names, "flash_fwd_kernel")
    if d == 256:
        assert (core, prepass, old) == (0, 0, 1), names
    else:
        assert (core, prepass, old) == (1, int(mask is not None or rope is not None), 0), names


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_k1_core_fully_masked_rows_and_lse(gen, d):
    """Batch 0 keeps no key: its rows average v over the n keys (not the
    padded length) and its lse is about -1e30; batch 1's lse matches
    attention_lse_plain. Keys of the first tiles all masked in batch 1 too, so
    the running max starts at -1e30 * log2(e) and must drop out exactly."""
    b, h, n = 2, 3, 300
    q, k, v = _projection_views(gen, b, h, n, d)
    mask = torch.zeros(b, n, dtype=torch.bool, device="cuda")
    mask[1, 200:290] = True  # batch 1: the first key tile all masked, then a run of kept keys
    rope = _rope(n, d)
    key_mask, cos, sin = fa._checked(q, k, v, mask, rope)
    out, lse = fa._forward_kernel(q, k, v, d ** -0.5, key_mask, cos, sin, with_lse=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    uniform = v[0].float().mean(dim=1, keepdim=True).expand(-1, n, -1)
    torch.testing.assert_close(out[0].float(), uniform, atol=TOL, rtol=0)
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v, d ** -0.5, mask, rope).float(),
                               atol=TOL, rtol=0)
    assert (lse[0] < -1e29).all()
    torch.testing.assert_close(lse[1], attention_lse_plain(q, k, d ** -0.5, mask, rope)[1], atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("d", [64, 128])
def test_k1_core_lse_matches_plain(gen, d, masked):
    """The lse the core writes for K2, at the CFM shape's layout (projection
    views, RoPE), without and with a ragged mask."""
    b, h, n = 2, 4, 1000
    q, k, v = _projection_views(gen, b, h, n, d)
    mask = _valid_mask(b, n, 937) if masked else None
    key_mask, cos, sin = fa._checked(q, k, v, mask, _rope(n, d))
    out, lse = fa._forward_kernel(q, k, v, d ** -0.5, key_mask, cos, sin, with_lse=True)
    assert lse.shape == (b, h, n) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, attention_lse_plain(q, k, d ** -0.5, mask, _rope(n, d)), atol=2e-2, rtol=0)
    plain_out, none = fa._forward_kernel(q, k, v, d ** -0.5, key_mask, cos, sin, with_lse=False)
    assert none is None and torch.equal(out, plain_out)  # writing the lse leaves the output's bits alone


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_k1_core_is_deterministic(gen, d):
    """Two calls give the same bits (no atomics; no stage refilled while a
    warp still reads it), with a mask and RoPE and without either."""
    q, k, v = _projection_views(gen, 2, 16, 1000, d)
    for mask, rope in ((_valid_mask(2, 1000, 937), _rope(1000, d)), (None, None)):
        first = flash_attention(q, k, v, d ** -0.5, key_mask=mask, rope=rope)
        for _ in range(2):
            assert torch.equal(flash_attention(q, k, v, d ** -0.5, key_mask=mask, rope=rope), first)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("d", [64, 128])
def test_k1_prepass_matches_plain_bit_for_bit(gen, d, masked):
    """The pre-pass's scratch against flash_prepass_plain: rope(q), rope(k)
    equal to apply_rotary_pos_emb (the JAX body's three roundings), rows
    past n zero, and the key biases; with a mask and no RoPE only the biases."""
    b, h, n = 2, 3, 937
    n_pad = 1024
    q, k = _projection_views(gen, b, h, n, d, count=2)
    mask = _valid_mask(b, n, 900) if masked else None
    for rope in (_rope(n, d), None):
        if rope is None and mask is None:
            continue
        before = fa.flash_prepass.launches
        got = fa.flash_prepass(q, k, mask, rope, n_pad)
        assert fa.flash_prepass.launches == before + 1
        want = fa.flash_prepass_plain(q, k, mask, rope, n_pad)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
        if rope is not None:
            assert torch.equal(got[0][:, :n].view(b, h, n, d), apply_rotary_pos_emb(q, rope))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_k2_rotation_matches_apply_rotary_pos_emb(gen, d):
    """K2's pre-pass rotates q and k with the forward's roundings: its qr and
    kr equal apply_rotary_pos_emb bit for bit."""
    b, h, n = 2, 3, 300
    q, k, v, g = _projection_views(gen, b, h, n, d, count=4)
    rope = _rope(n, d)
    key_mask, cos, sin = fa._checked(q, k, v, None, rope)
    out, lse = fa._forward_kernel(q, k, v, d ** -0.5, key_mask, cos, sin, with_lse=True)
    qr, kr = fa._backward_launch(q, k, v, out, lse, g, d ** -0.5, key_mask, cos, sin)[3:]
    torch.cuda.synchronize()
    assert torch.equal(qr, apply_rotary_pos_emb(q, rope)) and torch.equal(kr, apply_rotary_pos_emb(k, rope))


@pytest.mark.cuda
def test_k1_core_to_k2_gradients_at_the_main_shape(gen):
    """K1 (the core, writing the lse) then K2 through autograd at the
    sampling shape with its mask and RoPE, against the plain backward."""
    mask = _valid_mask(2, 1024, 937)
    got, ref = _grads_vs_plain(gen, 2, 16, 1024, 64, torch.bfloat16, mask, _rope(1024, 64), strided=True)
    for name, a, r in zip("qkv", got, ref):
        err = (a.float() - r).abs().max().item() / max(r.abs().max().item(), 0.1)
        assert err <= GRAD_TOL[torch.bfloat16], (f"d{name}", err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_attn_flat_is_deterministic_on_the_core(gen, d):
    """P2 runs the same core as P1: four calls give the same bits, equal to
    attn_pack2's."""
    q, k, v = _qkv(gen, 2, 16, 1000, d)
    first = av.attn_flat(q, k, v, d ** -0.5)
    for _ in range(3):
        assert torch.equal(av.attn_flat(q, k, v, d ** -0.5), first)
    assert torch.equal(av.attn_pack2(q, k, v, d ** -0.5), first)


# P1's, P3's and P4's outputs at fixed inputs before K1 and P2 moved onto the core (NVIDIA H100 80GB HBM3,
# torch 2.11.0+cu128): moving the core into csrc/attn_core.cuh and giving it a key bias and an lse left
# their arithmetic as it was. `chip_smoke.core_hashes` prints the same hashes.
CORE_HASHES = {
    "attn_pack2 [2, 16, 1024, 64]": "3a668cf2ac034abd68b99111975527610294fee3df4d58a698ca938ba387d799",
    "attn_pack2 [2, 4, 1000, 128]": "8de9df862ff3c1b2c4a6a88bf1afe1b2e4747aad5e176749500b1a8147a39375",
    "flash_nhd [2, 16, 1024, 64]": "c6e05453c86a49e9dc8b301e5da2c4862c81d015acdfcb564b4ce523691a0c63",
    "flash_nhd [2, 4, 1000, 128]": "457a6052546abe5a5cd6b35a0633aa12715cdd2b79233bad600fe10dece7721e",
    "flash_bhnd_rope [2, 16, 1024, 64]": "b4c2279a4aa40ee6e8a619c318c5d9a3ebd29e1b4cf0213a91e43b206bda42b3",
    "flash_bhnd_rope [2, 4, 1000, 128]": "3057c5214186f0ee1bc996ec278bad2abb71c72586c4744a4757b0884ed1c039",
}


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(CORE_HASHES))
def test_core_variants_keep_their_bits(gen, key):
    """P1, P3 and P4 on inputs made with numpy from a seed hash as they did
    before the core took a key bias and an lse."""
    import hashlib

    import numpy as np

    from f5_tts_tpu_torch.tools.fusion_probe import perm_matrix, rope_tables

    name, dims = key.split(" ", 1)
    b, h, n, d = (int(x) for x in dims.strip("[]").split(", "))
    rng = np.random.default_rng(n + d)
    shape = (b, n, h, d) if name == "flash_nhd" else (b, h, n, d)
    q, k, v = (torch.tensor(rng.standard_normal(shape, dtype=np.float32), device="cuda").to(torch.bfloat16)
               for _ in range(3))
    rope = () if name == "attn_pack2" else (*rope_tables(n, d, "cuda"), torch.tensor(perm_matrix(d), device="cuda"))
    out = getattr(av, name)(q, k, v, *rope, d ** -0.5)
    assert hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest() == CORE_HASHES[key]


# ------------------------------------------------------------ W8A8: quantize_rows, torch._int_mm, rescale_bias

# (m, k, n): the DiT's three shapes at the main path's 2 x 1024 frames, a ragged m, m <= 16 (padded to 32 rows
# for torch._int_mm), m = 17 (the least it takes unpadded) and one row
W8A8_SHAPES = [(2048, 1024, 1024), (2048, 1024, 2048), (2048, 2048, 1024), (1000, 1024, 1024), (5, 1024, 1024),
               (16, 64, 24), (17, 64, 24), (1, 256, 2048)]


def _w8a8_operands(gen, m, k, n, dtype):
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    # a row whose absmax is 127 puts codes exactly on .5: half to even, as the plain version rounds
    x[0, :6] = torch.tensor([127.0, 0.5, 1.5, -2.5, 63.5, -127.0], device="cuda").to(dtype)
    w8_, scale = w8.quantize_rows_plain(torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5)
    bias = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
    return x, w8_, scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", W8A8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_w8a8_kernels_match_plain_bit_for_bit(gen, shape, dtype):
    """quantize_rows (codes, sx, zero padding rows), rescale_bias (with and
    without a bias) and the whole W8A8 linear equal their plain versions to
    the bit; one count a kernel launch."""
    m, k, n = shape
    x, w8_, scale, bias = _w8a8_operands(gen, m, k, n, dtype)
    rows = max(m, 32)
    before = (w8.quantize_rows.launches, w8.rescale_bias.launches, w8.w8a8_linear.launches)
    codes, sx = w8.quantize_rows(x, rows)
    ref_codes, ref_sx = w8.quantize_rows_plain(x)
    assert torch.equal(codes[:m], ref_codes) and torch.equal(sx[:m], ref_sx) and not codes[m:].any()
    acc = w8.int8_product_plain(ref_codes, w8_)
    for b in (bias, None):
        assert torch.equal(w8.rescale_bias(acc, ref_sx, scale, b, dtype), w8.rescale_bias_plain(acc, ref_sx, scale, b, dtype))
        out = w8.w8a8_linear(x, w8_, scale, b)
        assert out.dtype == dtype and torch.equal(out, w8.w8a8_linear_plain(x, w8_, scale, b))
    assert (w8.quantize_rows.launches, w8.rescale_bias.launches, w8.w8a8_linear.launches) == \
        (before[0] + 3, before[1] + 4, before[2] + 2)


@pytest.mark.cuda
def test_w8a8_linear_launches_three_kernels_and_copies_nothing(gen):
    """One W8A8 linear at the DiT's shape is quantize_rows, one int8 GEMM on
    w8 as stored (no copy or transpose kernel) and rescale_bias; a
    [b, n, k] input keeps its leading shape."""
    x, w8_, scale, bias = _w8a8_operands(gen, 2048, 1024, 1024, torch.bfloat16)
    names = _cuda_kernel_names(lambda: w8.w8a8_linear(x.view(2, 1024, 1024), w8_, scale, bias))
    assert sum(names.values()) == 3, names
    assert _launched(names, "quantize_rows_kernel") == 1 and _launched(names, "rescale_bias_kernel") == 1, names
    assert w8.w8a8_linear(x.view(2, 1024, 1024), w8_, scale, bias).shape == (2, 1024, 1024)


@pytest.mark.cuda
def test_w8a8_refuses_what_it_does_not_take(gen):
    x, w8_, scale, bias = _w8a8_operands(gen, 64, 64, 24, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        w8.w8a8_linear(x[:, :60], w8_[:, :60].contiguous(), scale, bias)
    with pytest.raises(ValueError, match="bfloat16"):
        w8.w8a8_linear(x.half(), w8_, scale, bias)
    with pytest.raises(ValueError, match="is on cpu"):
        w8.w8a8_linear(x, w8_.cpu(), scale, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_w8a8_linear_module_on_the_card(gen, dtype):
    """`W8A8Linear.from_linear` of a linear held in the compute dtype, on
    the card, equals its CPU twin (the plain version) to the bit."""
    from torch import nn

    from f5_tts_tpu_torch.models.quant import W8A8Linear

    lin = nn.Linear(1024, 2048, device="cuda").to(dtype)
    x = torch.randn(2, 300, 1024, generator=gen, device="cuda").to(dtype)
    mod = W8A8Linear.from_linear(lin)
    cpu = W8A8Linear.from_linear(lin.cpu())
    for name in ("w8", "w8_scale", "bias"):
        assert torch.equal(getattr(mod, name).cpu(), getattr(cpu, name))
    assert torch.equal(mod(x).cpu(), cpu(x.cpu()))


@pytest.mark.cuda
def test_w8a8_dit_forward_launch_counts(gen):
    """One flow evaluation of a W8A8 DiT 22 blocks deep (the base depth, at
    width 256): 132 launches of each W8A8 kernel (6 linears a block), 22 of
    K1 and none of K3."""
    from f5_tts_tpu_torch.config import F5TTS_V1_BASE
    from f5_tts_tpu_torch.models.cfm import F5TTS

    cfg = F5TTS_V1_BASE.replace(dim=256, heads=4, text_dim=128, text_num_embeds=95, compute_dtype="bfloat16",
                                int8_compute=True)
    model = F5TTS.init(gen, cfg, device="cuda")
    dit = model._inference_dit()
    b, n = 2, 300
    x, cond = (torch.randn(b, n, 100, generator=gen, device="cuda") for _ in range(2))
    text = torch.randint(0, 95, (b, 40), generator=gen, device="cuda")
    with torch.no_grad():
        te = dit.embed_text(text, n)
        mods = {k: v[0] for k, v in dit.time_mods(torch.tensor([0.4], device="cuda")).items()}
        counters = (w8.quantize_rows, w8.rescale_bias, w8.w8a8_linear, flash_attention, qmatmul)
        before = [f.launches for f in counters]
        out = dit(x, cond, te, mods, mask=torch.ones(b, n, dtype=torch.bool, device="cuda"))
        torch.cuda.synchronize()
    assert [f.launches - n0 for f, n0 in zip(counters, before)] == [132, 132, 132, 22, 0]
    assert out.shape == (b, n, 100) and torch.isfinite(out).all()


# ------------------------------------------------------------ the registered operators (torch.export)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_attention_operator_launches_k1(gen, dtype):
    """K1's registered operator on CUDA tensors launches the kernel of its
    dtype (one count a call, the core's or the float32 kernel's name), its
    output in q's strides and its lse within tolerance of the plain
    versions; opcheck holds its fake version to it."""
    b, h, n, d = 2, 2, 300, 64
    q, k, v = (x.to(dtype) for x in _projection_views(gen, b, h, n, d))
    mask, (cos, sin) = _valid_mask(b, n, 250), _rope(n, d)
    op = torch.ops.f5_tts_tpu_torch.flash_attention_fwd
    counter = "launches" if dtype == torch.bfloat16 else "launches_f32"
    before = getattr(flash_attention, counter)
    names = _cuda_kernel_names(lambda: op(q, k, v, d ** -0.5, mask, cos, sin, True))
    assert getattr(flash_attention, counter) == before + 5
    kernel = "attn_core_fwd_kernel" if dtype == torch.bfloat16 else "flash_fwd_f32_tc_kernel"
    assert _launched(names, kernel) == 1, names
    out, lse = op(q, k, v, d ** -0.5, mask, cos, sin, True)
    assert out.stride() == q.stride() and lse.shape == (b, h, n)
    tol = TOL if dtype == torch.bfloat16 else TOL_F32
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v, d ** -0.5, mask, (cos, sin)).float(),
                               atol=tol, rtol=0)
    torch.testing.assert_close(lse, attention_lse_plain(q, k, d ** -0.5, mask, (cos, sin)), atol=tol, rtol=0)
    assert op(q, k, v, d ** -0.5, mask, cos, sin, False)[1].shape == (0,)
    torch.library.opcheck(fa.flash_attention_fwd, (q, k, v, d ** -0.5, mask, cos, sin, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_qmatmul_and_w8a8_operators_launch_their_kernels(gen, dtype):
    """K3's operator and the W8A8 linear's two on CUDA tensors launch their
    kernels (counts and profiler names) and match their plain versions
    (K3 within tolerance, quantize_rows and rescale_bias to the bit,
    quantize_rows' padding rows zero); opcheck holds their fake versions."""
    from f5_tts_tpu_torch.ops import qmatmul as qm

    m, n, k = 31, 1024, 1024
    q, scales, biases = (t.to(dtype) if t.is_floating_point() else t for t in _quantized(gen, n, k, 4))
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    counter = "launches" if dtype == torch.bfloat16 else "launches_f32"
    before = getattr(qmatmul, counter)
    names = _cuda_kernel_names(lambda: qm.qmatmul_op(x, q, scales, biases, None))
    assert getattr(qmatmul, counter) == before + 5
    assert _launched(names, "qmm_wgmma_kernel" if dtype == torch.bfloat16 else "qmm_tf32_kernel") == 1, names
    torch.testing.assert_close(qm.qmatmul_op(x, q, scales, biases, None).float(),
                               qmatmul_plain(x, q, scales, biases).float(),
                               atol=TOL if dtype == torch.bfloat16 else TOL_F32, rtol=0)
    torch.library.opcheck(qm.qmatmul_op, (x, q, scales, biases, None))

    x8 = x[:5]
    before = (w8.quantize_rows.launches, w8.rescale_bias.launches)
    names = _cuda_kernel_names(lambda: w8.quantize_rows_op(x8, 32))
    assert _launched(names, "quantize_rows_kernel") == 1, names
    codes, sx = w8.quantize_rows_op(x8, 32)
    ref_codes, ref_sx = w8.quantize_rows_plain(x8)
    assert torch.equal(codes[:5], ref_codes) and torch.equal(sx[:5], ref_sx) and not codes[5:].any()
    acc = w8.int8_product_plain(ref_codes, q)
    scale, bias = torch.rand(n, generator=gen, device="cuda"), torch.randn(n, generator=gen, device="cuda").to(dtype)
    names = _cuda_kernel_names(lambda: w8.rescale_bias_op(acc, ref_sx, scale, bias, dtype))
    assert _launched(names, "rescale_bias_kernel") == 1, names
    assert torch.equal(w8.rescale_bias_op(acc, ref_sx, scale, bias, dtype),
                       w8.rescale_bias_plain(acc, ref_sx, scale, bias, dtype))
    assert (w8.quantize_rows.launches - before[0], w8.rescale_bias.launches - before[1]) == (6, 6)
    torch.library.opcheck(w8.quantize_rows_op, (x8, 32))
    torch.library.opcheck(w8.rescale_bias_op, (acc, ref_sx, scale, bias, dtype))


@pytest.mark.cuda
def test_program_exported_on_the_cpu_runs_the_kernels_when_moved_to_the_card(gen, tmp_path):
    """A sampler exported and saved on the CPU, loaded with device="cuda"
    (moved by move_to_device_pass): its registered operators dispatch on
    their inputs' device, so the call launches K1 (depth x 2 evaluations of
    a 2-step Euler grid with CFG, one launch each) and agrees with the
    live sampler on the card within the served group's wave tolerance
    (relative L2 1.5e-2; chip_smoke.py SERVE_TOL)."""
    from f5_tts_tpu_torch import export as E
    from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, VocosConfig
    from f5_tts_tpu_torch.models.cfm import F5TTS
    from f5_tts_tpu_torch.models.vocos import Vocos

    g = torch.Generator().manual_seed(0)
    cfg = DiTConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, mel_dim=100, text_num_embeds=256,
                    text_dim=64, conv_layers=1, compute_dtype="bfloat16")
    model = F5TTS.init(g, cfg, device="cpu", cfm_cfg=CFMConfig(duration_bucket=64),
                       vocoder=Vocos.init(g, VocosConfig(dim=32, intermediate_dim=64, num_layers=2), device="cpu"))
    path = tmp_path / "cpu.bin"
    E.save_sampler(E.export_sampler(model, batch=1, steps=3, method="euler", embed_weights=False, device="cpu"),
                   path, model=model)
    with pytest.raises(ValueError, match="exported for cpu"):
        E.load_sampler(path)
    sampler, spec = E.load_sampler(path, device="cuda")
    assert sampler.device.type == "cuda"
    cond = torch.randn(1, 20, 100, generator=g) * 0.1
    text = torch.randint(0, 255, (1, 12), generator=g).numpy()
    args = E.prep_inputs(spec, cond.numpy(), text, 48, seed=5)
    before = flash_attention.launches
    _, wave = sampler.call(*args)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == cfg.depth * 2
    card = F5TTS(model.dit.cuda(), cfg, cfm_cfg=model.cfm_cfg, vocoder=model.vocoder.cuda())
    ref, _ = card.sample(cond.cuda(), text, duration=48, steps=3, method="euler", seed=5, return_trajectory=False)
    assert ((wave[0, :47 * 256] - ref).norm() / ref.norm()).item() < 1.5e-2


@pytest.mark.cuda
def test_artifact_over_a_data_grid_of_the_card_equals_its_shares(gen, tmp_path):
    """A batch-4 sampler with a symbolic batch, exported on the CPU and
    loaded onto the card, placed over a data-2 grid that repeats the card
    (`place_weights`): each data row's two rows equal to the bit to the
    one-device call on its share, K1 launched depth x 2 evaluations a data
    row, and one program and one weight copy on the card."""
    from f5_tts_tpu_torch import export as E
    from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, VocosConfig
    from f5_tts_tpu_torch.models.cfm import F5TTS
    from f5_tts_tpu_torch.models.vocos import Vocos
    from f5_tts_tpu_torch.parallel.mesh import create_mesh

    g = torch.Generator().manual_seed(0)
    cfg = DiTConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, mel_dim=100, text_num_embeds=256,
                    text_dim=64, conv_layers=1, compute_dtype="bfloat16")
    model = F5TTS.init(g, cfg, device="cpu", cfm_cfg=CFMConfig(duration_bucket=64),
                       vocoder=Vocos.init(g, VocosConfig(dim=32, intermediate_dim=64, num_layers=2), device="cpu"))
    path = tmp_path / "b4.bin"
    E.save_sampler(E.export_sampler(model, batch=4, steps=3, method="euler", embed_weights=False, device="cpu"),
                   path, model=model)
    sampler, spec = E.load_sampler(path, device="cuda")
    cond = (torch.randn(4, 20, 100, generator=g) * 0.1).numpy()
    text = torch.randint(0, 255, (4, 12), generator=g).numpy()
    args = E.prep_inputs(spec, cond, text, 48, seed=5)
    shares = [sampler.call(*(a[r * 2:(r + 1) * 2] if i in E._BATCHED else a for i, a in enumerate(args[:6])),
                           args[6]) for r in range(2)]
    sampler.place_weights(create_mesh(data=2, devices=["cuda:0"] * 2))
    before = flash_attention.launches
    mel, wave = sampler.call(*args)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 2 * cfg.depth * 2
    for r, (mel_r, wave_r) in enumerate(shares):
        assert torch.equal(mel[r * 2:(r + 1) * 2], mel_r) and torch.equal(wave[r * 2:(r + 1) * 2], wave_r), r
    assert list(sampler._modules) == list(sampler._weights_dev) == [torch.device("cuda", 0)]


@pytest.mark.cuda
def test_weights_bound_under_inference_mode_give_the_same_bits(gen, tmp_path):
    """A loaded sampler whose first call runs under `torch.inference_mode`
    (an artifact server's batcher thread) binds its weights as normal
    tensors on the card, parameters where the model had them, and its
    batch-1 wave equals that of one bound outside it, to the bit
    (inference-tensor weights took other matmul kernels at batch 1)."""
    from f5_tts_tpu_torch import export as E
    from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, VocosConfig
    from f5_tts_tpu_torch.models.cfm import F5TTS
    from f5_tts_tpu_torch.models.vocos import Vocos

    g = torch.Generator().manual_seed(0)
    cfg = DiTConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, mel_dim=100, text_num_embeds=256,
                    text_dim=64, conv_layers=1, compute_dtype="bfloat16")
    model = F5TTS.init(g, cfg, device="cpu", cfm_cfg=CFMConfig(duration_bucket=64),
                       vocoder=Vocos.init(g, VocosConfig(dim=32, intermediate_dim=64, num_layers=2), device="cpu"))
    path = tmp_path / "b1.bin"
    E.save_sampler(E.export_sampler(model, batch=1, steps=3, method="euler", embed_weights=False, device="cpu"),
                   path, model=model)
    args = E.prep_inputs(E.load_sampler(path, device="cpu")[1], (torch.randn(1, 20, 100, generator=g) * 0.1).numpy(),
                         torch.randint(0, 255, (1, 12), generator=g).numpy(), 48, seed=5)
    inside, _ = E.load_sampler(path, device="cuda")
    with torch.inference_mode():
        got = inside.call(*args)
    outside, _ = E.load_sampler(path, device="cuda")
    want = outside.call(*args)
    weights = inside._weights()[0]
    assert not any(w.is_inference() for w in weights.values())
    assert any(isinstance(w, torch.nn.Parameter) and w.requires_grad for w in weights.values())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ mesh inference: the shard shapes

# the base DiT's linears on a model axis of 2, (name, k, n), at m = 2 (CFG) x 2 rows a data row x 1024 frames
SHARD_M = 4096
SHARD_SHAPES = [("to_q/k/v", 1024, 512), ("to_out", 512, 1024), ("w1", 1024, 1024), ("w2", 1024, 1024)]


@pytest.mark.cuda
def test_k1_on_local_heads_of_strided_projections(gen):
    """K1 at [b, 8, n, 64], a slot's heads on a model axis of 2: q, k and v
    are strided [b, h, n, d] views of the local projections [b, n, 512], as
    the attention passes them, with a key mask and RoPE. Held to the plain
    version, and to the same heads of the whole 16-head attention to the
    bit (heads are independent)."""
    b, n, d = 4, 1000, 64
    x = torch.randn(b, n, 1024, generator=gen, device="cuda", dtype=torch.bfloat16)
    w = [torch.randn(1024, 1024, generator=gen, device="cuda", dtype=torch.bfloat16) / 32 for _ in range(3)]
    mask = torch.arange(n, device="cuda")[None, :] < torch.tensor([[n], [700], [n], [350]], device="cuda")
    rope = _rope(n, d)

    def heads(proj, h):
        return proj.view(b, n, h, d).transpose(1, 2)

    local = [heads(x @ wi[:, :512], 8) for wi in w]
    assert not local[0].is_contiguous()
    before = flash_attention.launches
    out = flash_attention(*local, d ** -0.5, key_mask=mask, rope=rope)
    assert flash_attention.launches == before + 1 and out.shape == (b, 8, n, d)
    torch.testing.assert_close(out.float(), flash_attention_plain(*local, d ** -0.5, mask, rope).float(),
                               atol=TOL, rtol=0)
    whole = flash_attention(*(heads(x @ wi, 16) for wi in w), d ** -0.5, key_mask=mask, rope=rope)
    assert torch.equal(out, whole[:, :8])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHARD_SHAPES, ids=[s[0] for s in SHARD_SHAPES])
def test_qmatmul_at_the_shard_shapes(gen, shape, dtype):
    """K3 (bf16) and K3-f32 at each linear's shard shape under a model axis
    of 2, int4, with and without the bias (a row-parallel slot leaves it to
    the reduced sum)."""
    _, k, n = shape
    q, scales, biases = _quantized(gen, n, k, 4)
    scales, biases = scales.to(dtype), biases.to(dtype)
    x = torch.randn(SHARD_M, k, generator=gen, device="cuda").to(dtype)
    bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(dtype)
    for b in (None, bias):
        before = (qmatmul.launches, qmatmul.launches_f32)
        out = qmatmul(x, q, scales, biases, b)
        counted = (qmatmul.launches - before[0], qmatmul.launches_f32 - before[1])
        assert counted == ((1, 0) if dtype == torch.bfloat16 else (0, 1))
        torch.testing.assert_close(out.float(), qmatmul_plain(x, q, scales, biases, b).float(),
                                   atol=TOL if dtype == torch.bfloat16 else TOL_F32, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(SHARD_M, 512), (SHARD_M, 1024), (1000, 1024), (5, 512), (17, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_w8a8_row_kernels_match_plain_bit_for_bit(gen, shape, dtype):
    """row_absmax and quantize_scaled (Triton) at the row-parallel inputs'
    slot shapes (attention to_out 512, feed-forward w2 1024), a ragged m
    and m <= 16 padded to 32 rows: equal to their plain versions, and the
    max over two slots' halves quantizes each half to the whole row's
    quantize_rows codes."""
    m, k = shape
    x, *_ = _w8a8_operands(gen, m, 2 * k, 8, dtype)
    rows = max(m, 32)
    before = (w8.row_absmax.launches, w8.quantize_scaled.launches)
    halves = [h.contiguous() for h in x.chunk(2, dim=-1)]
    amaxes = [w8.row_absmax(h) for h in halves]
    assert all(torch.equal(a, w8.row_absmax_plain(h)) for a, h in zip(amaxes, halves))
    amax = torch.maximum(*amaxes)
    whole_codes, whole_sx = w8.quantize_rows(x, rows)
    for h, codes_half in zip(halves, whole_codes.chunk(2, dim=-1)):
        codes, sx = w8.quantize_scaled(h, amax, rows)
        ref_codes, ref_sx = w8.quantize_scaled_plain(h, amax)
        assert torch.equal(codes[:m], ref_codes) and torch.equal(sx[:m], ref_sx) and not codes[m:].any()
        assert torch.equal(codes, codes_half) and torch.equal(sx, whole_sx)
    assert (w8.row_absmax.launches, w8.quantize_scaled.launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.cuda
def test_w8a8_dit_group_equals_unsharded_to_the_bit(gen):
    """One forward of a W8A8 DiT split over two slots of one card (a
    DiTGroup) against the unsharded W8A8 forward: equal to the bit, with
    the row-parallel kernels launched on each slot."""
    from f5_tts_tpu_torch.config import F5TTS_V1_BASE
    from f5_tts_tpu_torch.models.cfm import F5TTS
    from f5_tts_tpu_torch.parallel.mesh import all_reduce, create_mesh

    cfg = F5TTS_V1_BASE.replace(dim=256, depth=2, heads=4, text_dim=128, text_num_embeds=95,
                                compute_dtype="bfloat16", int8_compute=True)
    model = F5TTS.init(gen, cfg, device="cuda")
    dit = model._inference_dit()  # kept: use_mesh drops the model's own reference to it
    group, _ = model.use_mesh(create_mesh(model=2, devices=["cuda:0"] * 2))._inference_dit()[0]
    b, n = 2, 300
    x, cond = (torch.randn(b, n, 100, generator=gen, device="cuda") for _ in range(2))
    text = torch.randint(0, 95, (b, 40), generator=gen, device="cuda")
    with torch.no_grad():
        te = dit.embed_text(text, n)
        mods = {k: v[0] for k, v in dit.time_mods(torch.tensor([0.4], device="cuda")).items()}
        mask = torch.arange(n, device="cuda")[None] < torch.tensor([[n], [220]], device="cuda")
        ref = dit(x, cond, te, mods, mask=mask)
        before = (w8.row_absmax.launches, w8.quantize_scaled.launches, all_reduce.counts["max"])
        out = group(x, cond, te, mods, mask=mask)
        torch.cuda.synchronize()
    assert (w8.row_absmax.launches - before[0], w8.quantize_scaled.launches - before[1],
            all_reduce.counts["max"] - before[2]) == (8, 8, 4)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_istft_on_the_card_is_batch_invariant_and_matches_the_cpu(gen):
    """A vocoder's spectrum (any phase, the DC and Nyquist bins included)
    through `istft` on the card as a batch of 4 and as two batches of 2,
    against the CPU's: float32 sums in another order (1e-5 relative L2).
    cuFFT's C2R treats the DC and Nyquist bins' imaginary parts as it
    likes, and the CPU drops them."""
    from f5_tts_tpu_torch.audio.istft import istft
    from f5_tts_tpu_torch.audio.mel import hanning

    mag = torch.rand(4, 300, 513, generator=gen, device="cuda") * 10
    spec = torch.polar(mag, torch.randn(4, 300, 513, generator=gen, device="cuda") * 20)
    window = torch.as_tensor(hanning(1024), device="cuda")
    whole = istft(spec, window, 1024, 256, valid_frames=280)
    halves = torch.cat([istft(spec[r], window, 1024, 256, valid_frames=280) for r in (slice(0, 2), slice(2, 4))])
    cpu = istft(spec.cpu(), window.cpu(), 1024, 256, valid_frames=280)

    def rel(a, b):
        return ((a.cpu() - b.cpu()).norm() / b.cpu().norm()).item()

    assert rel(halves, whole) < 1e-5 and rel(whole, cpu) < 1e-5


# ------------------------------------------------------------ training over a mesh


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "row_masks"])
@pytest.mark.parametrize("dtype, h", [(torch.bfloat16, 8), (torch.float32, 4)], ids=["bf16", "f32"])
def test_k1_k2_at_the_training_slot_shape(gen, dtype, h, masked):
    """K1 (with its lse) and K2 at a 2 x 2 grid's slot shape in training: a
    data row's 2 of 4 rows at 1024 frames, the slot's heads of 64 as strided
    views of its [2, 1024, h * 64] projections; without a key mask (the
    training forward) and with a data row's lengths as key masks."""
    b, n, d = 2, 1024, 64
    projections = [torch.randn(b, n, h * d, generator=gen, device="cuda").to(dtype).requires_grad_() for _ in range(3)]
    q, k, v = (t.view(b, n, h, d).transpose(1, 2) for t in projections)
    mask = (torch.arange(n, device="cuda")[None, :] < torch.tensor([[924], [807]], device="cuda")) if masked else None
    rope = _rope(n, d)
    g = torch.randn(b, h, n, d, generator=gen, device="cuda").to(dtype)
    before = (flash_attention.launches + flash_attention.launches_f32,
              flash_attention.launches_bwd + flash_attention.launches_bwd_f32)
    out = flash_attention(q, k, v, d ** -0.5, key_mask=mask, rope=rope)
    got = torch.autograd.grad(out, projections, g)
    assert (flash_attention.launches + flash_attention.launches_f32,
            flash_attention.launches_bwd + flash_attention.launches_bwd_f32) == (before[0] + 1, before[1] + 1)
    ref_out = flash_attention_plain(q, k, v, d ** -0.5, mask, rope)
    ref = torch.autograd.grad(ref_out, projections, g)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOL if dtype == torch.bfloat16 else TOL_F32, rtol=0)
    for a, r in zip(got, ref):
        assert (a.float() - r.float()).abs().max().item() <= GRAD_TOL[dtype] * max(r.float().abs().max().item(), 0.1)


@pytest.mark.cuda
def test_sharded_training_step_on_the_card(gen, monkeypatch):
    """One CFM step of a float32 DiT (dim 256, 4 heads of 64) over 2 x 2
    slots of the card against the unsharded step from the same state and
    draws: the reduced gradient's relative L2, the loss and the parameters
    within 2e-5, and K1-f32 and K2-f32 launched 4 times a block (each slot
    its heads). cuDNN's TF32 is off here as in chip_smoke.py: the text
    embedding's convolutions otherwise take TF32 at the slots' batch and
    the unsharded batch alike, 3.3e-5 apart."""
    import copy

    from f5_tts_tpu_torch.config import CFMConfig, F5TTS_V1_BASE
    from f5_tts_tpu_torch.models.cfm import F5TTS, cfm_loss, draw_cfm
    from f5_tts_tpu_torch.models.shard import shard_train_state
    from f5_tts_tpu_torch.parallel import mesh as M
    from f5_tts_tpu_torch.training import trainer as T

    cfg = F5TTS_V1_BASE.replace(dim=256, depth=2, heads=4, text_dim=128, text_num_embeds=95, compute_dtype="float32")
    model = F5TTS.init(gen, cfg, device="cuda", cfm_cfg=CFMConfig())
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    b, n = 4, 256
    mel = torch.randn(b, n, 100, generator=gen, device="cuda")
    text = torch.randint(0, 95, (b, 60), generator=gen, device="cuda", dtype=torch.int32)
    lens = torch.tensor([n, 230, 200, 160], device="cuda")
    draws = draw_cfm(gen, model.cfm_cfg, b, n, 100, torch.device("cuda"))
    opt = T.make_optimizer(1e-5, 1e-2, 0, 100)
    step = T.make_train_step(model.cfm_cfg, opt)
    ref = copy.deepcopy(model.dit)
    loss1 = step(T.init_train_state(ref, opt), mel, text, lens, draws=draws).item()
    ref0 = copy.deepcopy(model.dit)
    mesh = M.create_mesh(data=2, model=2, devices=["cuda:0"] * 4)
    state = shard_train_state(T.init_train_state(model.dit, opt), mesh)
    sharded = M.shard_train_step(step, mesh, state)
    loss0 = cfm_loss(ref0, model.cfm_cfg, mel, text, lens, draws=draws)
    want = dict(zip((k for k, _ in ref0.named_parameters()), torch.autograd.grad(loss0, list(ref0.parameters()))))
    _, grads = sharded.gradients(state, mel, text, lens, draws=draws)
    flat = torch.cat([(grads[k] - want[k]).flatten() for k in want])
    assert flat.norm().item() <= 2e-5 * torch.cat([w.flatten() for w in want.values()]).norm().item()
    before = (flash_attention.launches_f32, flash_attention.launches_bwd_f32)
    loss2 = sharded(state, mel, text, lens, draws=draws).item()
    assert (flash_attention.launches_f32 - before[0], flash_attention.launches_bwd_f32 - before[1]) == (8, 8)
    assert abs(loss2 - loss1) <= 2e-5 * abs(loss1)
    got = M.gather_state(state)["params"]
    for name, p in ref.named_parameters():
        torch.testing.assert_close(got[name], p, atol=2e-5, rtol=0, msg=name)
