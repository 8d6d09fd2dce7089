"""The arithmetic of the float32 dequantizing matmul (K3-f32), on the CPU.

The kernel runs its products on the tensor cores in 3xTF32: the weight is
dequantized in float32 (q * s, then + b, as `dequantize_kernel`), the
weight and x are each split into hi = rounded to TF32 and lo = (value - hi)
rounded to TF32 (`tf32_split_plain`, bit-exact to the kernel's
`cvt.rna.tf32.f32`), and y sums lo_x hi_W + hi_x lo_W, then hi_x hi_W, in
float32; lo_x lo_W is dropped. TF32 products are exact in float32, so a
float32 matmul of the split operands is the tensor cores' product up to the
order of its sums. Here that emulation is held to the JAX package's
`quantized_matmul` and its Pallas kernel (`_qmm_call`, in interpret mode on
the CPU) at 1e-4 absolute on O(1) outputs, the tolerance the kernel is held
to on the card against its plain version; one TF32 product (hi_x hi_W)
misses it, which is why the kernel takes three. The kernel's launch plan
(`plan_f32`) is checked against the shared memory a block may use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import quant as jq
from f5_tts_tpu.ops.qmatmul import qmatmul as jax_qmatmul
from f5_tts_tpu_torch.ops import qmatmul as qm
from f5_tts_tpu_torch.ops.flash_attention import tf32_split_plain

F32_TOL = 1e-4


def _port_params(p: dict) -> tuple[torch.Tensor, ...]:
    """A JAX quantized leaf {q [k, n], scales, biases [k/64, n]} in the
    port's [n, k] layout."""
    return tuple(torch.tensor(np.ascontiguousarray(np.asarray(p[name]).T)) for name in ("q", "scales", "biases"))


def _products(x: torch.Tensor, w: torch.Tensor, passes: int) -> torch.Tensor:
    """x [m, k] @ w [n, k]^T with TF32-split operands: the kernel's three
    products (passes = 3) or the hi products alone (passes = 1)."""
    xh, xl = tf32_split_plain(x)
    wh, wl = tf32_split_plain(w)
    hi = xh @ wh.T
    return hi if passes == 1 else (xl @ wh.T + xh @ wl.T) + hi


def qmm_3xtf32(x, q, scales, biases, bias=None, passes: int = 3) -> torch.Tensor:
    """The kernel's function as it computes it: dequantize in float32, split,
    take the products in float32, then add the linear's bias."""
    y = _products(x, qm.dequantize_kernel(q, scales, biases), passes)
    return y if bias is None else y + bias


def _case(bits, m, k, n):
    rng = np.random.default_rng(bits * 100_000 + m * 100 + k + n)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    p = jq.quantize_kernel(w, bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return p, x, bias


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("k", [64, 1024])
@pytest.mark.parametrize("m", [1, 31, 130])
@pytest.mark.parametrize("bits", [4, 8])
def test_3xtf32_emulation_matches_jax(bits, m, k, n):
    """The emulated kernel against `quantized_matmul` and the Pallas kernel,
    without and with the linear's bias (added after the product on both
    sides)."""
    p, x, bias = _case(bits, m, k, n)
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), p))
    pallas = np.asarray(jax_qmatmul(jnp.asarray(x), p))
    args = (torch.tensor(x), *_port_params(p))
    for b, shift in ((None, 0), (torch.tensor(bias), bias)):
        got = qmm_3xtf32(*args, b).numpy()
        assert got.shape == (m, n) and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref + shift, atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(got, pallas + shift, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("bits", [4, 8])
def test_one_tf32_product_misses_the_tolerance(bits):
    """hi_x hi_W alone (single-pass TF32) misses 1e-4 at k = 1024, where
    the three products meet it."""
    p, x, _ = _case(bits, 64, 1024, 256)
    ref = np.asarray(jq.quantized_matmul(jnp.asarray(x), p))
    args = (torch.tensor(x), *_port_params(p))
    assert np.abs(qmm_3xtf32(*args).numpy() - ref).max() <= F32_TOL
    assert np.abs(qmm_3xtf32(*args, passes=1).numpy() - ref).max() > 2 * F32_TOL


@pytest.mark.parametrize("n", [100, 512, 1024, 2048, 6144])
@pytest.mark.parametrize("m", [1, 31, 32, 33, 64, 65, 130, 256, 1024, 2048, 2049])
def test_f32_launch_plan(m, n):
    """The plan is one of the kernel's four instances, with a token tile no
    larger than the bf16 kernel's; it takes the most work a block that keeps
    F32_MIN_BLOCKS blocks, or the most blocks; its grid covers [m, n]; its
    ring fits the 227 KB a block may use."""
    tile, rows, grid = qm.plan_f32(m, n)
    assert (tile, rows) in qm.F32_PLANS and tile <= qm.token_tile(m)
    assert grid == (-(-n // rows), -(-m // tile))
    allowed = [(t, r) for t, r in qm.F32_PLANS if t <= qm.token_tile(m)]
    blocks = {(t, r): -(-n // r) * -(-m // t) for t, r in allowed}
    full = [p for p in allowed if blocks[p] >= qm.F32_MIN_BLOCKS]
    assert (tile, rows) == (full[0] if full else max(allowed, key=blocks.get))
    assert qm.f32_smem_bytes(tile, rows) <= qm.SMEM_LIMIT


def test_f32_plan_at_the_main_path_shapes():
    """The DiT blocks' linears at 2 x 1024 frames take two warpgroups and
    128 tokens a block; at 2 x 128 frames (the float32 DiT check's input) and
    at m = 31 the 32-token tile; the ring of each instance fits."""
    assert qm.plan_f32(2048, 1024) == (128, 128, (8, 16))
    assert qm.plan_f32(2048, 2048) == (128, 128, (16, 16))
    assert qm.plan_f32(256, 1024) == (32, 64, (16, 8))
    assert qm.plan_f32(31, 6144) == (32, 64, (96, 1))
    assert qm.plan_f32(2048, 100) == (32, 64, (2, 64))
    for tile, rows in qm.F32_PLANS:
        assert qm.f32_smem_bytes(tile, rows) <= qm.SMEM_LIMIT
