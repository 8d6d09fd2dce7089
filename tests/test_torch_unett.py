"""E2 TTS's UNetT on the port (`models/unett.py`), on the CPU at a tiny size.

The training forward, with and without dropout and RoPE on one head or on
all, and one `make_train_step` step (its loss and each leaf's gradient as
AdamW took it) are held to the plain float32 reference `plain_unett.py`;
the attention's plain versions with `rope_heads` to rotating the first
heads by hand, and without it to the call as it was; the plain RMSNorm
to x_transformers' form and its backward to autograd; and every path the
port does not take a UNetT on raises. The kernels are tested on the card
(`tests/test_torch_cuda.py`) against these plain versions.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import plain_unett as PU
from f5_tts_tpu_torch.config import E2TTS_BASE, CFMConfig, DiTConfig, UNetTConfig
from f5_tts_tpu_torch.models.cfm import F5TTS, draw_cfm
from f5_tts_tpu_torch.models.dit import DiTGroup
from f5_tts_tpu_torch.models.quant import quantize_module_, w8a8_blocks_
from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb, rotary_freqs
from f5_tts_tpu_torch.models.shard import shard_model_for_inference, shard_model_for_training
from f5_tts_tpu_torch.models.unett import UNetT
from f5_tts_tpu_torch.ops import flash_attention as FA
from f5_tts_tpu_torch.ops.attention import sdpa_reference
from f5_tts_tpu_torch.ops.rms_norm import rms_norm, rms_norm_bwd_plain, rms_norm_plain, rms_norm_stats_plain
from f5_tts_tpu_torch.parallel.mesh import create_mesh
from f5_tts_tpu_torch.parallel.pipeline import create_pipeline_mesh, shard_params_for_pipeline
from f5_tts_tpu_torch.training.trainer import init_train_state, make_optimizer, make_train_step
from f5_tts_tpu_torch.utils.modules import init_parameters_

TINY = dict(dim=64, depth=4, heads=4, dim_head=16, ff_mult=4, mel_dim=100, text_num_embeds=256, text_dim=100)
CFM = dict(audio_drop_prob=0.3, cond_drop_prob=0.2, frac_lengths_mask=(0.7, 1.0))


def _model(pe_attn_head=1, dropout=0.0, remat=False) -> UNetT:
    """A tiny UNetT with seeded weights, its norms' g away from 1."""
    model = UNetT(UNetTConfig(**TINY, pe_attn_head=pe_attn_head, dropout=dropout, remat=remat))
    g = torch.Generator().manual_seed(0)
    init_parameters_(model, g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".g"):
                p.uniform_(0.5, 1.5, generator=g)
    return model


def _plain_cfg(model: UNetT) -> dict:
    c = model.cfg
    return {"depth": c.depth, "heads": c.heads, "pe_attn_head": c.pe_attn_head}


def _weights(model: UNetT) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _batch(seed=1, b=3, n=40):
    g = torch.Generator().manual_seed(seed)
    lens = torch.tensor([n, n - 7, n - 15][:b])
    mel = torch.randn(b, n, 100, generator=g) * (torch.arange(n)[None, :, None] < lens[:, None, None])
    text = torch.randint(0, 256, (b, 12), generator=g)
    text[1:, 9:] = -1
    return mel, text, lens


def _close(got, want, rel):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= rel * max(want.abs().max().item(), 1e-30), (err, want.abs().max().item())


@pytest.mark.parametrize("pe_attn_head", [1, None])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_forward_matches_the_plain_reference(pe_attn_head, dropout):
    model = _model(pe_attn_head, dropout)
    g = torch.Generator().manual_seed(3)
    x, cond = torch.randn(2, 33, 100, generator=g), torch.randn(2, 33, 100, generator=g)
    text = torch.randint(-1, 256, (2, 10), generator=g)
    time = torch.rand(2, generator=g)
    flags = torch.tensor([False, True])
    with torch.no_grad():
        got = model.forward_train(x, cond, text, time, drop_audio_cond=flags, drop_text=False,
                                  generator=torch.Generator().manual_seed(7) if dropout else None)
        P = _weights(model)
        drops = PU.Dropout(torch.Generator().manual_seed(7), 4, dropout).layers() if dropout else None
        want = torch.cat([PU.forward(P, _plain_cfg(model), x[i:i + 1], cond[i:i + 1], text[i:i + 1], time[i:i + 1],
                                     bool(flags[i]), False, drops and [_rows(d, i) for d in drops])
                          for i in range(2)])
    assert got.dtype == torch.float32 and got.shape == (2, 33, 100)
    _close(got, want, 2e-6)


def _rows(drop, i):
    """A plain dropout of one batch row: the whole batch's mask, row i."""
    def one(where, x):
        full = torch.ones((2,) + x.shape[1:])
        return x * drop(where, full)[i:i + 1]
    return one


def test_rope_on_one_head_differs_from_every_head():
    """pe_attn_head 1 (E2 TTS Base) and None (every head rotated, the DiT's
    convention) give other outputs."""
    x = torch.randn(1, 20, 100)
    outs = []
    for pe in (1, None):
        with torch.no_grad():
            outs.append(_model(pe).forward_train(x, x, torch.zeros(1, 5, dtype=torch.long), torch.tensor([0.5])))
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("pe_attn_head,remat", [(1, False), (None, False), (1, True)])
def test_train_step_matches_the_plain_loss_and_gradients(pe_attn_head, remat):
    """One step of `make_train_step` over `init_train_state`, dropout on:
    the loss and, leaf by leaf, the gradient AdamW took (its first moment
    over 1 - b1, no clip), against the plain reference's autograd."""
    model = _model(pe_attn_head, dropout=0.1, remat=remat)
    P = {n: t.requires_grad_() for n, t in _weights(model).items()}
    opt = make_optimizer(learning_rate=1e-3, weight_decay=0.01, num_warmup_steps=1, total_steps=10, max_grad_norm=0.0)
    cfm_cfg = CFMConfig(**CFM)
    step = make_train_step(cfm_cfg, opt, ema_decay=0.99)
    state = init_train_state(model, opt, ema=True)
    mel, text, lens = _batch()
    draws = draw_cfm(torch.Generator().manual_seed(11), cfm_cfg, 3, mel.shape[1], 100, torch.device("cpu"))
    loss = step(state, mel, text, lens, generator=torch.Generator().manual_seed(5), draws=draws)
    drops = PU.Dropout(torch.Generator().manual_seed(5), 4, 0.1).layers()
    want = PU.cfm_loss(P, _plain_cfg(model), CFM, mel, text, lens, vars(draws), drops)
    grads = torch.autograd.grad(want, list(P.values()))
    assert abs(float(loss) - float(want.detach())) <= 1e-6 * float(want.detach())
    assert state.step == 1 and set(state.opt_state["mu"]) == set(P)
    for (name, _), g in zip(P.items(), grads):
        _close(state.opt_state["mu"][name] / (1 - opt.b1), g, 2e-5)


def _qkv(h=4, n=24, d=16, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, h, n, d, generator=g).to(dtype) for _ in range(3))
    raw = rotary_freqs(n, d)
    return q, k, v, (torch.cos(raw), torch.sin(raw))


def _turn_first(x, rope, r):
    out = x.clone()
    out[:, :r] = apply_rotary_pos_emb(x[:, :r], rope)
    return out


@pytest.mark.parametrize("rope_heads", [0, 1, 3])
def test_plain_attention_rotates_only_the_first_heads(rope_heads):
    q, k, v, rope = _qkv()
    want = sdpa_reference(_turn_first(q, rope, rope_heads), _turn_first(k, rope, rope_heads), v, 0.25)
    assert torch.equal(FA.flash_attention(q, k, v, 0.25, rope=rope, rope_heads=rope_heads), want)
    assert torch.equal(FA.flash_attention_plain(q, k, v, 0.25, rope=rope, rope_heads=rope_heads), want)
    qr, kr, _ = FA.flash_prepass_plain(q.bfloat16(), k.bfloat16(), None, rope, 128, rope_heads)
    assert torch.equal(qr[:, :24].view(2, 4, 24, 16), _turn_first(q.bfloat16(), rope, rope_heads))
    assert torch.equal(kr[:, :24].view(2, 4, 24, 16), _turn_first(k.bfloat16(), rope, rope_heads))
    # the gradient through the plain backward stages against autograd of the written-out rotation
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = FA.flash_attention(qs, ks, vs, 0.25, rope=rope, rope_heads=rope_heads)
    gout = torch.randn_like(out)
    got = torch.autograd.grad(out, (qs, ks, vs), gout)
    q2, k2, v2 = (t.clone().requires_grad_() for t in (q, k, v))
    ref = sdpa_reference(_turn_first(q2, rope, rope_heads), _turn_first(k2, rope, rope_heads), v2, 0.25)
    for a, b in zip(got, torch.autograd.grad(ref, (q2, k2, v2), gout)):
        _close(a, b, 1e-5)


def test_rope_heads_none_or_all_is_the_call_without_it():
    """Forward, lse, both pre-passes, the backward and its epilogue: bit for
    bit the call without `rope_heads`."""
    q, k, v, rope = _qkv()
    g = torch.randn_like(q)
    base = FA.flash_attention_plain(q, k, v, 0.25, rope=rope)
    for heads in (None, 4):
        assert torch.equal(FA.flash_attention_plain(q, k, v, 0.25, rope=rope, rope_heads=heads), base)
        assert torch.equal(FA.flash_attention(q, k, v, 0.25, rope=rope, rope_heads=heads), base)
        assert torch.equal(FA.attention_lse_plain(q, k, 0.25, rope=rope, rope_heads=heads),
                           FA.attention_lse_plain(q, k, 0.25, rope=rope))
        mask = torch.arange(24)[None] < torch.tensor([[24], [19]])
        for a, b in zip(FA.flash_prepass_plain(q, k, mask, rope, 128, heads), FA.flash_prepass_plain(q, k, mask, rope, 128)):
            assert torch.equal(a, b)
        for a, b in zip(FA.flash_attention_bwd_plain(q, k, v, base, g, 0.25, rope=rope, rope_heads=heads),
                        FA.flash_attention_bwd_plain(q, k, v, base, g, 0.25, rope=rope)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="rope_heads"):
        FA.flash_attention(q, k, v, 0.25, rope=rope, rope_heads=5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_rms_norm_is_x_transformers_form(dtype):
    g = torch.Generator().manual_seed(2)
    x = (torch.randn(3, 17, 64, generator=g) * 3).to(dtype)
    w = torch.rand(64, generator=g) + 0.5
    want = F.normalize(x.float(), dim=-1) * math.sqrt(64) * w
    got = rms_norm_plain(x, w)
    assert got.dtype == dtype
    _close(got, want, 1e-6 if dtype == torch.float32 else 4e-3)
    assert torch.equal(rms_norm(x, w), got)
    r = rms_norm_stats_plain(x)
    _close(r, 1.0 / x.float().norm(dim=-1), 1e-6)
    xs, ws = x.float().requires_grad_(), w.clone().requires_grad_()
    dy = torch.randn(3, 17, 64, generator=g)
    want_dx, want_dg = torch.autograd.grad(F.normalize(xs, dim=-1) * math.sqrt(64) * ws, (xs, ws), dy)
    dx, dg = rms_norm_bwd_plain(x, dy, w, r)
    _close(dx, want_dx, 1e-5)
    _close(dg, want_dg, 1e-5)


def test_layout_and_size():
    """The published checkpoint's names, and E2 TTS Base's 333 M parameters."""
    names = [n for n, _ in _model().named_parameters()]
    assert "layers.0.0.weight" not in names and "layers.2.0.weight" in names and "norm_out.g" in names
    assert {n.split(".", 3)[2] for n in names if n.startswith("layers.")} == {"0", "1", "2", "3", "4"}
    with torch.device("meta"):
        base = UNetT(E2TTS_BASE)
    assert sum(p.numel() for p in base.parameters()) == 333_241_544
    assert base.cfg.pe_attn_head == 1 and base.cfg.ff_mult == 4 and base.cfg.dropout == 0.1


@pytest.mark.parametrize("depth", [3, 5])
def test_an_odd_depth_raises(depth):
    with pytest.raises(ValueError, match="even"):
        UNetT(UNetTConfig(**dict(TINY, depth=depth)))


@pytest.mark.parametrize("path", ["F5TTS", "int4", "w8a8", "shard_module", "shard_for_training", "DiTGroup",
                                  "pipeline"])
def test_out_of_scope_paths_raise(path):
    model = _model()
    calls = {
        "F5TTS": lambda: F5TTS(model, DiTConfig()),
        "int4": lambda: quantize_module_(model, 4),
        "w8a8": lambda: w8a8_blocks_(model),
        "shard_module": lambda: shard_model_for_inference(model, create_mesh(data=1, model=2,
                                                                             devices=["cpu"] * 2)),
        "shard_for_training": lambda: shard_model_for_training(model, create_mesh(data=1, model=2,
                                                                                  devices=["cpu"] * 2)),
        "DiTGroup": lambda: DiTGroup([model]),
        "pipeline": lambda: shard_params_for_pipeline(model, create_pipeline_mesh(2, 1, ["cpu"] * 2)),
    }
    with pytest.raises(ValueError, match="UNetT"):
        calls[path]()
    assert np.isfinite(float(next(model.parameters()).detach().sum()))
