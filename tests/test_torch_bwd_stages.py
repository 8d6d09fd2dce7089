"""The stages of the attention backward's plain version, and K3's launch
plan, on the CPU.

K2's bf16 path runs as a pre-pass (rotated q', k' and delta =
rowsum(g * out)), the main kernels (dQ', dK', dV) and an epilogue (the RoPE
backward, one rounding to the output dtype). `bwd_prepass_plain`,
`bwd_main_plain` and `bwd_epilogue_plain` are those stages in plain
PyTorch; each, and their composition `flash_attention_bwd_plain`, is held to
the JAX package: `jax.vjp` of `f5_tts_tpu.ops.flash_attention`, whose custom
VJP runs the Pallas backward kernel in interpret mode on the CPU, and the
JAX rotary embedding. Inputs come from a numpy seed.

Tolerances: float32 1e-5 absolute on O(1) values (the same float32 math
summed in another order). bf16: the rotation within two bf16 ulps (both
sides round x cos, x_swap sin and their sum to bf16, XLA possibly fusing
them in float32); the gradients 3e-2 absolute (both sides round the
rotated q and k, P and dS to bf16 at slightly different points: one or two
bf16 ulps at magnitude 2); the epilogue within one bf16 ulp (the same
float32 arithmetic, rounded once).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.models import rope as jrope
from f5_tts_tpu.ops.flash_attention import flash_attention as jax_flash
from f5_tts_tpu_torch.ops import qmatmul as qm
from f5_tts_tpu_torch.ops.flash_attention import (
    bwd_epilogue_plain,
    bwd_main_plain,
    bwd_prepass_plain,
    flash_attention_bwd_plain,
)

SCALE = 0.125
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
GRAD_ATOL = {"f32": 1e-5, "bf16": 3e-2}


def _inputs(seed, n=37):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((2, 2, n, 64)).astype(np.float32) for _ in range(4))
    raw = np.asarray(jrope.rotary_freqs(n, 64))
    mask = np.arange(n)[None, :] < np.array([n - 10, n])[:, None]
    return q, k, v, g, np.cos(raw), np.sin(raw), mask


def _t(x, dtype):
    return torch.tensor(np.asarray(x, np.float32)).to(dtype)


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _jax_vjp(q, k, v, g, mask, rope, jdt):
    """JAX's forward output and its (dq, dk, dv) for cotangent g."""
    out, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, SCALE, mask, rope=rope),
                       *(jnp.asarray(a, jdt) for a in (q, k, v)))
    return out, vjp(jnp.asarray(g, jdt))


@pytest.mark.parametrize("with_rope", [False, True], ids=["no-rope", "rope"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bwd_prepass_matches_jax(dt, with_rope):
    q, k, v, g, cos, sin, mask = _inputs(seed=1)
    tdt, jdt = DTYPES[dt]
    rope = (cos, sin) if with_rope else None
    out, _ = _jax_vjp(q, k, v, g, jnp.asarray(mask), rope and tuple(map(jnp.asarray, rope)), jdt)
    qr, kr, delta = bwd_prepass_plain(_t(q, tdt), _t(k, tdt), _t(g, tdt), _t(out, tdt),
                                      rope and tuple(torch.tensor(t) for t in rope))
    assert qr.dtype == kr.dtype == tdt and delta.dtype == torch.float32 and delta.shape == (2, 2, 37)
    for got, x in ((qr, q), (kr, k)):
        ref = jnp.asarray(x, jdt)
        if with_rope:
            ref = jrope.apply_rotary_pos_emb(ref, tuple(map(jnp.asarray, rope)))
        tol = dict(atol=1e-5, rtol=0) if dt == "f32" else dict(atol=1e-3, rtol=2 ** -7)
        torch.testing.assert_close(got.float(), torch.tensor(_f32(ref)), **tol)
    ref_delta = (jnp.asarray(g, jdt).astype(jnp.float32) * out.astype(jnp.float32)).sum(-1)
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref_delta), atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bwd_main_matches_jax(dt, with_mask):
    """The main stage on already rotated q', k' against JAX's backward
    without RoPE on the same rotated inputs."""
    q, k, v, g, cos, sin, mask = _inputs(seed=2)
    tdt, jdt = DTYPES[dt]
    rope = (jnp.asarray(cos), jnp.asarray(sin))
    qr, kr = (_f32(jrope.apply_rotary_pos_emb(jnp.asarray(x, jdt), rope)) for x in (q, k))
    jm = jnp.asarray(mask) if with_mask else None
    out, ref = _jax_vjp(qr, kr, v, g, jm, None, jdt)
    delta = (torch.tensor(_f32(out)) * _t(g, tdt).float()).sum(-1)
    got = bwd_main_plain(_t(qr, tdt), _t(kr, tdt), _t(v, tdt), _t(g, tdt), delta, SCALE,
                         torch.tensor(mask) if with_mask else None)
    for name, a, b in zip(("dq'", "dk'", "dv"), got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), _f32(b), atol=GRAD_ATOL[dt], rtol=0, err_msg=name)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bwd_epilogue_matches_jax(dt):
    """The RoPE backward with tables rounded to the inputs' dtype, in float32,
    against jax.vjp of the JAX rotation with those tables; then one rounding
    to the output dtype, and dv passed through."""
    rng = np.random.default_rng(3)
    dqr, dkr, dv = (rng.standard_normal((2, 2, 37, 64)).astype(np.float32) for _ in range(3))
    _, _, _, _, cos, sin, _ = _inputs(seed=3)
    tdt, jdt = DTYPES[dt]
    tables = tuple(jnp.asarray(t, jdt).astype(jnp.float32) for t in (cos, sin))
    _, vjp = jax.vjp(lambda x: jrope.apply_rotary_pos_emb(x, tables), jnp.zeros_like(jnp.asarray(dqr)))
    got = bwd_epilogue_plain(*(torch.tensor(x) for x in (dqr, dkr, dv)), (torch.tensor(cos), torch.tensor(sin)),
                             tdt, out_dtype=tdt)
    for a, x, rotated in zip(got, (dqr, dkr, dv), (True, True, False)):
        ref = torch.tensor(_f32(vjp(jnp.asarray(x))[0]) if rotated else x).to(tdt)
        assert a.dtype == tdt
        tol = dict(atol=1e-5, rtol=0) if dt == "f32" else dict(atol=0, rtol=2 ** -8)
        torch.testing.assert_close(a.float(), ref.float(), **tol)


@pytest.mark.parametrize("with_rope", [False, True], ids=["no-rope", "rope"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bwd_stages_compose_to_jax(dt, with_mask, with_rope):
    """pre-pass -> main -> epilogue (flash_attention_bwd_plain) against the
    whole JAX backward, the output dtype the inputs'."""
    q, k, v, g, cos, sin, mask = _inputs(seed=4)
    tdt, jdt = DTYPES[dt]
    rope = (cos, sin) if with_rope else None
    out, ref = _jax_vjp(q, k, v, g, jnp.asarray(mask) if with_mask else None,
                        rope and tuple(map(jnp.asarray, rope)), jdt)
    got = flash_attention_bwd_plain(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(out, tdt), _t(g, tdt), SCALE,
                                    torch.tensor(mask) if with_mask else None,
                                    rope and tuple(torch.tensor(t) for t in rope), out_dtype=tdt)
    for name, a, b in zip("qkv", got, ref):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(), _f32(b), atol=GRAD_ATOL[dt], rtol=0, err_msg=f"d{name}")


# ------------------------------------------------------------ K3's launch plan


def _qmm_shapes():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return [(m, n) for _, m, _, n in module.QMM_SHAPES]


PLAN_SHAPES = sorted(set(_qmm_shapes()) | {(m, n) for m in (1, 8, 129, 2049) for n in (100, 1000)})


@pytest.mark.parametrize("m,n", PLAN_SHAPES, ids=[f"m{m}-n{n}" for m, n in PLAN_SHAPES])
def test_qmm_plan_covers_the_shape(m, n):
    """The grid covers every output with no empty block, and the token tile
    is the smallest that holds m (the largest past 128 rows)."""
    tile, (col_blocks, tok_blocks) = qm.plan(m, n)
    assert tile in qm.TOKEN_TILES
    assert tile == min([t for t in qm.TOKEN_TILES if t >= m], default=max(qm.TOKEN_TILES))
    assert col_blocks * qm.W_ROWS >= n > (col_blocks - 1) * qm.W_ROWS
    assert tok_blocks * tile >= m > (tok_blocks - 1) * tile
