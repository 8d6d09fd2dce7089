"""The attention kernel against its plain version on an NVIDIA GPU.

Marked `cuda`; each test skips without a CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance 2e-2 absolute on O(1) outputs: both sides round P and the rotated
q and k to bf16 at different points.
"""

import pytest
import torch

from f5_tts_tpu_torch.models.rope import rotary_freqs
from f5_tts_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
def test_rejects_what_the_kernel_does_not_take(gen):
    q, k, v = _qkv(gen, 1, 2, 16, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float(), 0.125)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :32], k[..., :32], v[..., :32], 0.125)
    with pytest.raises(ValueError, match="key_mask"):
        flash_attention(q, k, v, 0.125, key_mask=torch.ones(1, 16, device="cuda"))
    with pytest.raises(ValueError, match="rope"):
        flash_attention(q, k, v, 0.125, rope=tuple(t.to(torch.bfloat16) for t in _rope(16, 64)))
    qt = torch.randn(1, 2, 64, 16, generator=gen, device="cuda", dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="strides"):
        flash_attention(qt, k, v, 0.125)
