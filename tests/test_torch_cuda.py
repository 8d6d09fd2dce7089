"""The CUDA kernels against their plain versions on an NVIDIA GPU: the
attention kernel (bf16 and float32) and the dequantizing matmul.

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, absolute on O(1) outputs: 2e-2 in bf16 (attention: both sides
round P and the rotated q and k to bf16 at different points; matmul: both
round W to bf16, and they sum in another order and round the output); 1e-4
in float32 (the same float32 math summed in another order). TF32 is off.
"""

import pytest
import torch

from f5_tts_tpu_torch.models.quant import quantize_kernel
from f5_tts_tpu_torch.models.rope import rotary_freqs
from f5_tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
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
