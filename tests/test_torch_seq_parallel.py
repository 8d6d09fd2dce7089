"""Sequence parallelism in the port's training (a mesh's "seq" axis,
parallel/mesh.py): the query-block attention that it rests on
(ops/flash_attention.py, `q_offset`), the sharded step over data x seq x
model grids whose slots repeat the one CPU device, against the JAX
package's sequence-sharded step on its 8 virtual CPU devices
(tests/conftest.py; `sequence_sharding`, the counterpart of
tests/test_training.py:159) and against the port's unsharded step.

Both packages start from the same parameters (`params_from_jax`) and see the
same draws (the JAX key split as the JAX loss splits it, handed to the port
for the global batch). Tolerances as in tests/test_torch_mesh_training.py:
the loss within 2e-5 of the JAX sharded step and of the port's unsharded
step; every parameter after one AdamW step at lr 1e-3 within 2e-5 of the
port's unsharded step, and against JAX within lr / 10 with 99.9% within
1e-6 and proj_out within the JAX suite's 2e-5. The blocks of a query-block
call are the full call's rows in float32 within 1e-6 (the same products
summed over the same keys).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu import config as jcfg
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from f5_tts_tpu.parallel import mesh as jmesh
from f5_tts_tpu.training import trainer as JT
from f5_tts_tpu.training.duration_trainer import make_duration_train_step as jax_duration_step
from f5_tts_tpu_torch import config as tcfg
from f5_tts_tpu_torch.config import AudioConfig
from f5_tts_tpu_torch.models import blocks as B
from f5_tts_tpu_torch.models.cfm import CFMDraws
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb, rotary_freqs
from f5_tts_tpu_torch.models.shard import gather_shards, shard_train_state
from f5_tts_tpu_torch.ops import flash_attention as fa
from f5_tts_tpu_torch.parallel import mesh as tmesh
from f5_tts_tpu_torch.training import trainer as T
from f5_tts_tpu_torch.training.duration_trainer import make_duration_train_step

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256, text_dim=32,
            conv_layers=1)
DUR = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32, conv_layers=1)
FPS = 24_000 / 256
LR = 1e-3


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _jax_draws(key, b, n) -> CFMDraws:
    """The draws of JAX `cfm_loss(key)` for a batch of b, split as it splits them."""
    k_frac, k_span, k_x0, k_time, k_adrop, k_tdrop, _ = jax.random.split(key, 7)
    lo, hi = jcfg.CFMConfig().frac_lengths_mask
    return CFMDraws(
        frac_lengths=_t(jax.random.uniform(k_frac, (b,), minval=lo, maxval=hi)),
        span_start=_t(jax.random.uniform(k_span, (b,))),
        x0=_t(jax.random.normal(k_x0, (b, n, 100), dtype=jnp.float32)),
        time=_t(jax.random.uniform(k_time, (b,), dtype=jnp.float32)),
        audio_drop=_t(jax.random.uniform(k_adrop, (1,))),
        text_drop=_t(jax.random.uniform(k_tdrop, (1,))),
    )


def _batch(b=4, n=48, seed=1, k=None):
    rng = np.random.default_rng(seed)
    lead = (b,) if k is None else (k, b)
    mel = rng.standard_normal(lead + (n, 100)).astype(np.float32)
    text = rng.integers(0, 255, lead + (20,)).astype(np.int32)
    text[..., 0, 12:] = -1
    lens = np.full(lead, n, np.int32)
    lens[..., -1] = n - 9
    return mel, text, lens


def _params(module) -> dict:
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def _close(got: dict, want: dict, atol=2e-5):
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        torch.testing.assert_close(p, want[k], atol=atol, rtol=0, msg=k)


def _jax_params(tree, cfg) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree), cfg).items()}


def _close_to_jax(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    diffs = []
    for k, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref[k], atol=LR / 10, rtol=0, err_msg=k)
        diffs.append(np.abs(p.numpy() - ref[k]).ravel())
    assert np.mean(np.concatenate(diffs) <= 1e-6) >= 0.999
    np.testing.assert_allclose(got["proj_out.weight"].numpy(), ref["proj_out.weight"], atol=2e-5, rtol=0)


def cpu(n):
    return ["cpu"] * n


@pytest.fixture(scope="module")
def jax_params():
    return JaxF5TTS.init(jax.random.key(0), jcfg.DiTConfig(**TINY, use_flash_attention=False)).params


def _port_dit(jax_params, **cfg) -> DiT:
    dit = DiT(tcfg.DiTConfig(**{**TINY, **cfg}))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_params), dit.cfg))
    return dit


def _cfm_step(opt, k=1, audio=False):
    if audio:
        return T.make_train_step_from_audio(tcfg.CFMConfig(), opt, audio_cfg=AudioConfig(), grad_accum=k)
    return T.make_train_step(tcfg.CFMConfig(), opt, grad_accum=k)


def _port_steps(model, make, inputs, draws, grid, fsdp=False, generator=None, k=1):
    """The port's unsharded step and its sharded step over `grid` (data,
    seq, model) of CPU slots, from the same parameters and draws:
    (unsharded loss, its parameters, sharded loss, the sharded state, the
    sharded step's collectives)."""
    opt = T.make_optimizer(LR, 1e-2, 1, 100)
    ref = type(model)(model.cfg)
    ref.load_state_dict(model.state_dict())
    step = make(opt, k)

    def gen():
        return None if generator is None else torch.Generator().manual_seed(generator)

    loss1 = step(T.init_train_state(ref, opt), *inputs, gen(), draws=draws).item()
    mesh = tmesh.create_mesh(**grid, devices=cpu(grid["data"] * grid["seq"] * grid["model"]))
    state = shard_train_state(T.init_train_state(model, opt), mesh, fsdp=fsdp)
    tmesh.reset_collective_counts()
    loss2 = tmesh.shard_train_step(step, mesh, state, grad_accum=k, fsdp=fsdp)(state, *inputs, gen(),
                                                                               draws=draws).item()
    return loss1, _params(ref), loss2, state, tmesh.collective_counts()


# ------------------------------------------------------------- query-block attention


def _qkv(n=48, b=2, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.tensor(rng.standard_normal((b, h, n, d)).astype(np.float32)) for _ in range(4))
    raw = rotary_freqs(n, d)
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[1, n - 7:] = False
    return q, k, v, g, (torch.cos(raw), torch.sin(raw)), mask


@pytest.mark.parametrize("seq", [2, 3])
def test_query_blocks_match_the_full_call(seq):
    """A seq slot's rows of q at their offset against every key: the blocks'
    outputs, log-sum-exps and dq rows are the full call's rows, and the
    seq sums of their dk and dv the full call's dk and dv (float32, RoPE, a
    key mask; the plain versions, and `flash_attention` with autograd as
    training calls it). Rotating a block by the table's last rows, as
    `apply_rotary_pos_emb` does, turns every block but the last as if it
    ended the sequence."""
    q, k, v, g, rope, mask = _qkv()
    n, scale = q.shape[2], 32 ** -0.5
    out = fa.flash_attention_plain(q, k, v, scale, mask, rope)
    lse = fa.attention_lse_plain(q, k, scale, mask, rope)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, out, g, scale, mask, rope)
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for f in tmesh.seq_frames(seq, n):
        qb, gb = f.take(q, 2), f.take(g, 2)
        ob = fa.flash_attention_plain(qb, k, v, scale, mask, rope, q_offset=f.start)
        torch.testing.assert_close(ob, f.take(out, 2), atol=1e-6, rtol=0)
        torch.testing.assert_close(fa.attention_lse_plain(qb, k, scale, mask, rope, f.start), f.take(lse, 2),
                                   atol=1e-6, rtol=0)
        dqb, dkb, dvb = fa.flash_attention_bwd_plain(qb, k, v, ob, gb, scale, mask, rope, q_offset=f.start)
        torch.testing.assert_close(dqb, f.take(dq, 2), atol=1e-6, rtol=0)
        dk_sum, dv_sum = dk_sum + dkb, dv_sum + dvb
        # the autograd path the training forward takes
        qa, ka, va = (t.clone().requires_grad_(True) for t in (qb, k, v))
        oa = fa.flash_attention(qa, ka, va, scale, mask, rope, q_offset=f.start)
        torch.testing.assert_close(oa, ob, atol=0, rtol=0)
        ga = torch.autograd.grad(oa, (qa, ka, va), gb)
        for got, want in zip(ga, (dqb, dkb, dvb)):
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
        if f.stop < n:  # the trap: a block but the last, rotated by the last rows of the table
            wrong = fa.flash_attention_plain(apply_rotary_pos_emb(qb, rope), apply_rotary_pos_emb(k, rope), v, scale,
                                             mask)
            assert (wrong - ob).abs().max() > 1e-2
    torch.testing.assert_close(dk_sum, dk, atol=1e-6, rtol=0)
    torch.testing.assert_close(dv_sum, dv, atol=1e-6, rtol=0)


def test_query_block_arguments_are_checked():
    """Shapes and offsets a kernel would read past are refused (`_checked`
    runs before any CUDA launch): a block past the keys, tables of the
    block's length, a mask of the block's length; bf16 at d 256 and float32
    at d 128 refuse a block."""
    q, k, v, _, rope, mask = _qkv(n=64, d=64)
    qb = q[:, :, :32]
    with pytest.raises(ValueError, match="does not lie"):
        fa._checked(qb, k, v, mask, rope, 40)
    with pytest.raises(ValueError, match="table"):
        fa._checked(qb, k, v, mask, tuple(t[:32] for t in rope), 32)
    with pytest.raises(ValueError, match="key_mask"):
        fa._checked(qb, k, v, mask[:, :32], rope, 32)
    fa._checked(qb, k, v, mask, rope, 32)
    for dtype, d in ((torch.bfloat16, 256), (torch.float32, 128)):
        x = torch.zeros(1, 1, 64, d, dtype=dtype)
        with pytest.raises(ValueError, match="query block"):
            fa._checked(x[:, :, :32], x, x, None, None, 32)
        fa._checked(x, x, x, None, None)


# ------------------------------------------------------------- the sharded step


def _jax_seq_sharded(step_fn, params, batch, key, fsdp=False):
    """The JAX package's step on its 2 x 2 x 2 (data x seq x model) mesh,
    mel and text sequence-sharded: (loss, state)."""
    opt = JT.make_optimizer(LR, 1e-2, 1, 100)
    mesh = jmesh.create_mesh(data=2, model=2, seq=2)
    params = jax.tree.map(lambda x: jnp.array(x, copy=True), params)  # the sharded step donates its state
    state = jmesh.shard_state(JT.init_train_state(params, opt), mesh, fsdp=fsdp)
    sharded = jmesh.shard_train_step(step_fn(opt), mesh, state, fsdp=fsdp)
    ssh, dsh = jmesh.sequence_sharding(mesh), jmesh.batch_sharding(mesh)
    mel, text, lens = (jnp.asarray(a) for a in batch)
    state, loss = sharded(state, jax.device_put(mel, ssh), jax.device_put(text, ssh), jax.device_put(lens, dsh), key)
    return float(loss), state


@pytest.mark.parametrize("fsdp", [False, True])
def test_seq_step_matches_jax_sharded_and_unsharded(jax_params, fsdp):
    """2 x 2 x 2 (test_training.py:159): the loss, and every parameter after
    one step; under FSDP the text embedding stays off "data"."""
    batch = _batch()
    key = jax.random.key(3)
    jloss, jstate = _jax_seq_sharded(
        lambda opt: JT.make_train_step(jcfg.DiTConfig(**TINY, use_flash_attention=False), jcfg.CFMConfig(), opt),
        jax_params, batch, key, fsdp=fsdp)
    loss1, params1, loss2, state, counts = _port_steps(_port_dit(jax_params), _cfm_step, tuple(_t(a) for a in batch),
                                                       _jax_draws(key, 4, 48), dict(data=2, seq=2, model=2), fsdp)
    assert abs(loss2 - jloss) <= 2e-5 and abs(loss2 - loss1) <= 2e-5
    got = gather_shards(state)
    _close(got, params1)
    _close_to_jax(got, _jax_params(jstate["params"], tcfg.DiTConfig(**TINY)))
    # a k, v gather an attention a model column a data row, and its reduce-scatter in the backward
    assert counts["seq_all_gather"] == counts["seq_reduce_scatter"] == 2 * 2 * 2
    assert state.mesh.axis_names == ("data", "seq", "model") and len(state.slots) == 8
    if fsdp:
        assert all("data" not in state.specs[n] for n in state.specs if n.startswith("text_embed."))
        assert counts["all_gather"] == counts["reduce_scatter"] > 0


@pytest.mark.parametrize("cfg", [dict(dropout=0.2), dict(dropout=0.2, remat=True)])
def test_dropout_and_remat_under_seq_match_unsharded(jax_params, cfg):
    """1 x 2 x 2: each slot applies its rows, hidden columns and frames of
    the unsharded dropout mask; with remat the recompute repeats the
    forward's gathers. Exact counts: a gather an attention a model column
    (again in the recompute), a reduce-scatter in the backward, and the
    row-parallel sums of each seq slot's model group."""
    passes = 3 if cfg.get("remat") else 2
    loss1, params1, loss2, state, counts = _port_steps(_port_dit(jax_params, **cfg), _cfm_step,
                                                       tuple(_t(a) for a in _batch()), None,
                                                       dict(data=1, seq=2, model=2), generator=7)
    assert abs(loss2 - loss1) <= 2e-5
    _close(gather_shards(state), params1)
    depth = TINY["depth"]
    assert counts["seq_all_gather"] == depth * 2 * (passes - 1)
    assert counts["seq_reduce_scatter"] == depth * 2
    assert counts["all_reduce_sum"] == 2 * 2 * depth * passes  # 2 seq slots' model groups, 2 linears a block
    assert counts["seq_sum"] == 0


@pytest.mark.parametrize("audio", [False, True])
def test_grad_accum_and_the_audio_step_under_seq(jax_params, audio):
    """grad_accum=2 over 2 x 2 x 1 (each microbatch splits its rows over
    "data" and its frames over "seq"), and the audio step
    (`make_train_step_from_audio`: the log-mel of the whole batch first,
    then the split) over 1 x 2 x 2, against the unsharded steps."""
    if audio:
        rng = np.random.default_rng(5)
        wave = torch.tensor(rng.standard_normal((2, 47 * 256)).astype(np.float32) * 0.1)
        inputs = (wave, torch.tensor(rng.integers(0, 255, (2, 12)).astype(np.int32)), torch.tensor([47, 40]))
        grid, k = dict(data=1, seq=2, model=2), 1
        draws = _jax_draws(jax.random.key(8), 2, 47)
        with pytest.raises(ValueError, match="frames are not divisible"):  # 47 frames over seq 2
            _port_steps(_port_dit(jax_params), lambda o, kk: _cfm_step(o, kk, audio=True), inputs, draws, grid)
        wave = wave[:, :46 * 256]
        inputs = (wave, inputs[1], torch.tensor([46, 40]))
        draws = _jax_draws(jax.random.key(8), 2, 46)
    else:
        inputs, grid, k = tuple(_t(a) for a in _batch(k=2)), dict(data=2, seq=2, model=1), 2
        draws = [_jax_draws(mk, 4, 48) for mk in jax.random.split(jax.random.key(3), 2)]
    loss1, params1, loss2, state, counts = _port_steps(_port_dit(jax_params), lambda o, kk: _cfm_step(o, kk, audio),
                                                       inputs, draws, grid, k=k)
    assert abs(loss2 - loss1) <= 2e-5
    _close(gather_shards(state), params1)
    assert counts["seq_all_gather"] == k * TINY["depth"] * grid["data"] * grid["model"]


def test_input_window_shorter_than_the_convolutions_reach(jax_params):
    """n 32 over seq 4: a slot's 8 frames are fewer than the 30 that the
    conv position embedding's two k31 convolutions reach, so each window is
    clipped to the sequence at both ends; each slot's frames of the input
    embedding equal the whole sequence's, and the step equals unsharded. A
    window padded past the sequence's end instead is not the sequence's:
    mish(conv(0) + bias) is not 0."""
    dit = _port_dit(jax_params)
    rng = np.random.default_rng(4)
    x, cond = (torch.tensor(rng.standard_normal((2, 32, 100)).astype(np.float32)) for _ in range(2))
    text_embed = torch.tensor(rng.standard_normal((2, 32, 32)).astype(np.float32))
    whole = dit.input_embed(x, cond, text_embed)
    for f in tmesh.seq_frames(4, 32):
        assert f.window(30) == (0, 32)
        torch.testing.assert_close(B.embed_frames(dit.input_embed, f, x, cond, text_embed), f.take(whole), atol=1e-6,
                                   rtol=0)
    padded = dit.input_embed(*(torch.nn.functional.pad(t, (0, 0, 0, 30)) for t in (x, cond, text_embed)))
    assert (padded[:, :32] - whole).abs().max() > 1e-3
    loss1, params1, loss2, state, _ = _port_steps(dit, _cfm_step, tuple(_t(a) for a in _batch(n=32)),
                                                  _jax_draws(jax.random.key(6), 4, 32), dict(data=1, seq=4, model=1))
    assert abs(loss2 - loss1) <= 2e-5
    _close(gather_shards(state), params1)


def test_frames_that_seq_does_not_divide_raise(jax_params):
    """As the data axis refuses a batch it does not divide (and JAX's
    `device_put` to P("data", "seq") refuses the frames)."""
    with pytest.raises(ValueError, match="50 frames are not divisible by the mesh's seq-axis size 4"):
        _port_steps(_port_dit(jax_params), _cfm_step, tuple(_t(a) for a in _batch(n=50)), None,
                    dict(data=1, seq=4, model=1), generator=1)


def test_duration_step_over_seq_matches_jax_and_unsharded():
    """DURATION's step over 1 x 2 x 2 against the JAX package's unsharded
    duration step (test_duration_trainer.py) and the port's: the masked
    mean's sums join in a counted seq sum (forward and backward) before the
    linear and the softplus."""
    jp = JaxDurationPredictor.init(jax.random.key(3), jcfg.DurationConfig(**DUR, use_flash_attention=False)).params
    port = DurationPredictor(tcfg.DurationConfig(**DUR))
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), port.cfg))
    rng = np.random.default_rng(9)
    batch = (rng.standard_normal((4, 40, 100)).astype(np.float32), rng.integers(0, 200, (4, 8)).astype(np.int32),
             np.array([40, 31, 40, 22], np.int32))
    key = jax.random.key(4)
    opt = JT.make_optimizer(LR, 1e-2, 1, 100)
    jstep = jax.jit(jax_duration_step(jcfg.DurationConfig(**DUR, use_flash_attention=False), opt, FPS))
    jstate, jloss = jstep(JT.init_train_state(jax.tree.map(lambda x: jnp.array(x, copy=True), jp), opt),
                          *(jnp.asarray(a) for a in batch), key)
    rand_frac = _t(jax.random.uniform(jax.random.split(key)[0], (4,)))
    loss1, params1, loss2, state, counts = _port_steps(port, lambda o, k: make_duration_train_step(o, FPS, grad_accum=k),
                                                       tuple(_t(a) for a in batch), rand_frac,
                                                       dict(data=1, seq=2, model=2))
    assert abs(loss2 - float(jloss)) <= 2e-5 and abs(loss2 - loss1) <= 2e-5
    got = gather_shards(state)
    _close(got, params1)
    ref = _jax_params(jstate["params"], tcfg.DurationConfig(**DUR))
    for k, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref[k], atol=LR / 10, rtol=0, err_msg=k)
    assert counts["seq_sum"] == 2 and counts["seq_all_gather"] == DUR["depth"] * 2


def test_seq_slots_own_nothing_and_store_their_columns_pieces(jax_params):
    """Slots are row-major over (data, seq, model); a seq slot holds a copy
    of its (data row, model column)'s pieces (FSDP's too), owns none, and a
    gathered state counts each piece once."""
    mesh = tmesh.create_mesh(data=2, seq=2, model=2, devices=cpu(8))
    state = shard_train_state(T.init_train_state(_port_dit(jax_params), T.make_optimizer()), mesh, fsdp=True)
    assert [(s.row, s.seq, s.col) for s in state.slots] == [(r, q, j) for r in range(2) for q in range(2)
                                                            for j in range(2)]
    for s, slot in enumerate(state.slots):
        twin = s - 2 if slot.seq else s  # its seq index 0
        for name, spec in state.specs.items():
            assert torch.equal(state.params[s][name], state.params[twin][name]), name
            assert tmesh.owns(spec, slot.row, slot.col, slot.seq) == (slot.seq == 0 and tmesh.owns(spec, slot.row,
                                                                                                    slot.col))
    _close(gather_shards(state), _params(_port_dit(jax_params)), atol=0)
