"""The port's guidance-interval sampling (`F5TTS.sample(cfg_interval=...)`,
`cfm_sample_segmented`) against the JAX package's segmented path, and the
cases `tests/test_cfg_interval.py` pins, within the port.

The tiny DiT of `tests/test_cfg_interval.py` (dim 64, depth 2, 2 heads x 32,
text_dim 32, 64-frame buckets) with proj_out scaled by 0.01, so that an
untrained flow stays finite; the JAX parameters reach the port through
`params_from_jax`. Tolerances: 1e-3 on the mel against JAX with the same
y0, as the port's pipeline parity tests; 1e-5 within the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu_torch.config import CFMConfig, DiTConfig
from f5_tts_tpu_torch.models.cfm import F5TTS, sway_time_grid
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
            text_num_embeds=64, text_dim=32, conv_layers=1)


@pytest.fixture(scope="module")
def models():
    jax_model = JaxF5TTS.init(jax.random.key(0), JaxDiTConfig(**TINY, use_flash_attention=False),
                              cfm_cfg=JaxCFMConfig(duration_bucket=64))
    jax_model.params["proj_out"] = jax.tree.map(lambda x: x * 0.01, jax_model.params["proj_out"])
    dit = DiT(DiTConfig(**TINY))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_model.params), DiTConfig(**TINY)))
    return jax_model, F5TTS(dit, DiTConfig(**TINY), cfm_cfg=CFMConfig(duration_bucket=64))


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_interval_matches_jax(models, method):
    """(0.2, 0.6) over a 6-point swayed grid: guidance off, on, off. Batch 2
    with per-item durations and the same y0 on both sides."""
    jax_model, port = models
    rng = np.random.default_rng(4)
    cond = (0.5 * rng.standard_normal((2, 16, 100))).astype(np.float32)
    text = np.array([[7, 12, 3, 9], [4, 5, -1, -1]], np.int32)
    durations = np.array([48, 40], np.int32)
    y0 = rng.standard_normal((2, 48, 100)).astype(np.float32)
    kw = dict(duration=durations, lens=np.array([16, 12]), steps=6, method=method, cfg_strength=2.0,
              sway_sampling_coef=-1.0, cfg_interval=(0.2, 0.6))
    ts = sway_time_grid(6, -1.0)
    assert list((ts[:-1] >= 0.2) & (ts[:-1] <= 0.6)) == [False, False, False, True, False]
    ref_out, ref_traj = jax_model.sample(jnp.asarray(cond), jnp.asarray(text), y0=jnp.asarray(y0), **kw)
    got_out, got_traj = port.sample(cond, text, y0=y0, **kw)
    assert tuple(got_out.shape) == ref_out.shape == (2, 48, 100)
    assert tuple(got_traj.shape) == ref_traj.shape == (6, 2, 48, 100)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_traj.numpy(), np.asarray(ref_traj), atol=1e-3, rtol=0)


def _sample(port, **kw):
    rng = np.random.default_rng(1)
    cond = (0.5 * rng.standard_normal((1, 16, 100))).astype(np.float32)
    text = np.array([[7, 12, 3]], np.int32)
    out, traj = port.sample(cond, text, duration=48, steps=6, method="euler", seed=3, **kw)
    return out.numpy(), traj.numpy()


def test_full_interval_matches_default(models):
    _, port = models
    o1, t1 = _sample(port)
    assert np.isfinite(o1).all()
    o2, t2 = _sample(port, cfg_interval=(0.0, 1.0))
    np.testing.assert_allclose(o1, o2, atol=1e-5, rtol=0)
    assert t1.shape == t2.shape


def test_interval_covering_nothing_equals_cfg_zero(models):
    _, port = models
    o1, _ = _sample(port, cfg_interval=(2.0, 3.0))
    o2, _ = _sample(port, cfg_strength=0.0)
    np.testing.assert_allclose(o1, o2, atol=1e-5, rtol=0)


def test_no_trajectory_returns_final_state(models):
    """Without the trajectory each segment yields only its end state; the
    result must still be the last segment's, as with the trajectory."""
    _, port = models
    o_traj, t_full = _sample(port, cfg_interval=(0.0, 0.5))
    o_last, t_last = _sample(port, cfg_interval=(0.0, 0.5), return_trajectory=False)
    np.testing.assert_allclose(o_traj, o_last, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_last[0], t_full[-1], atol=1e-5, rtol=0)
    assert t_last.shape[0] == 1


def test_partial_interval_keeps_trajectory_length(models):
    _, port = models
    o1, t1 = _sample(port)
    o2, t2 = _sample(port, cfg_interval=(0.0, 0.5))
    assert t2.shape == t1.shape
    assert np.isfinite(o2).all()
    assert np.abs(o1 - o2).max() > 1e-6  # guidance off in the tail changes the result


def test_segments_run_the_conditional_stream_alone(models, monkeypatch):
    """Each run of steps is one `cfm_sample_mel` call; the steps outside the
    interval run at cfg_strength 0, the conditional stream alone."""
    from f5_tts_tpu_torch.models import cfm

    _, port = models
    calls = []
    real = cfm.cfm_sample_mel

    def spy(dit, y0, *a, cfg_strength=2.0, **kw):
        calls.append((len(a[3]), cfg_strength))
        return real(dit, y0, *a, cfg_strength=cfg_strength, **kw)

    monkeypatch.setattr(cfm, "cfm_sample_mel", spy)
    _sample(port, cfg_interval=(0.0, 0.5))
    # grid 0, .2, .4, .6, .8, 1 swayed by -1: the first steps start in [0, 0.5]
    assert [c[1] for c in calls] == [2.0, 0.0]
    assert sum(n - 1 for n, _ in calls) == 5  # every step once
