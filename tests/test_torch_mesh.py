"""Mesh-parallel inference in the port (`f5_tts_tpu_torch/parallel/mesh.py`,
`F5TTS.use_mesh`, `generate(mesh=...)`, `serve` over a mesh) on the CPU, on
grids whose slots repeat the one CPU device, as the JAX suite meshes 8
virtual CPU devices (tests/conftest.py).

Against the JAX package: `create_mesh` (shapes, axis names, device order,
errors), `param_specs` (the sharded dim of every tensor of a float, an int4
and a W8A8 tree, mapped through `params_from_jax`), and a 4 x 2 sample
against JAX's `use_mesh` sample with the same weights and noise (atol =
rtol = 2e-4, the JAX suite's own tolerance for that comparison,
tests/test_mesh_serving.py). Against the port unsharded: the cfg_interval
branch under data 4, int4 under model 2 (dim 256, 4 heads of 64, so that
each slot's quantized inputs stay a multiple of 64), W8A8 under 2 x 2 to
the bit, the row-parallel linears' bias added once, a served request within
2 LSB, and `generate(mesh=...)` leaving a caller's model unsharded. Tiny
float32 configs; the tolerances of the float sharded-vs-unsharded checks
are float32 sums taken in another order (1e-5) or over several 2-step
evaluations (2e-5 on int4's larger sums).
"""

import io
import json
import urllib.request
import wave as wave_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.config import VocosConfig as JaxVocosConfig
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.quant import quantize_tree, w8a8_blocks
from f5_tts_tpu.models.vocos import Vocos as JaxVocos
from f5_tts_tpu.parallel import mesh as jmesh
from f5_tts_tpu_torch import generate as tgen
from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, VocosConfig
from f5_tts_tpu_torch.models.blocks import Attention, FeedForward, row_parallel
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.quant import QuantizedLinear, W8A8Linear, quantize_module_, w8a8_blocks_
from f5_tts_tpu_torch.models.shard import shard_module
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.ops import w8a8 as W
from f5_tts_tpu_torch.parallel import mesh as tmesh
from f5_tts_tpu_torch.serve import serve


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's torch work on one thread, restored after it. The suite's
    workers share the CPU's cores, and torch's default of one thread a core
    in each makes their OpenMP pools spin against each other: on an 8-core
    CPU, six concurrent runs of the scaling tool's sampling and pipeline
    halves took 414 s each so and 4.5 s each on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256, text_dim=32,
            conv_layers=1)
WIDE = dict(TINY, dim=256, heads=4, dim_head=64)  # int4 under model 2: 128 and 256 inputs a slot
VOCOS = dict(dim=64, intermediate_dim=128, num_layers=2)
TEXTS = ["first sentence", "the second one", "third"]
DURS = np.array([120, 90, 150], np.int32)


def cpu(n):
    return ["cpu"] * n


def _port_model(dit_cfg=TINY, seed=0):
    g = torch.Generator().manual_seed(seed)
    return F5TTS.init(g, DiTConfig(**dit_cfg), device="cpu", cfm_cfg=CFMConfig(duration_bucket=64),
                      vocoder=Vocos.init(g, VocosConfig(**VOCOS), device="cpu"))


def _cond(seed=5):
    return np.random.default_rng(seed).standard_normal((3, 32, 100)).astype(np.float32)


def _sample(model, **kw):
    return model.sample(_cond(), TEXTS, **{"duration": DURS, "steps": 2, "method": "euler", "seed": 7, **kw})


# ------------------------------------------------------------- create_mesh against JAX


@pytest.mark.parametrize("data, model, seq", [(None, 1, 1), (None, 2, 1), (4, 2, 1), (2, 2, 2), (8, 1, 1),
                                              (1, 8, 1), (2, 1, 4), (3, 2, 1)])
def test_create_mesh_matches_jax(data, model, seq):
    """The same axis names, shape and device order as JAX's `create_mesh`
    over the suite's 8 virtual devices (the port's over 8 distinct device
    names, which need no card)."""
    jm = jmesh.create_mesh(data=data, model=model, seq=seq)
    tm = tmesh.create_mesh(data=data, model=model, seq=seq, devices=[torch.device("cuda", i) for i in range(8)])
    assert tuple(jm.axis_names) == tm.axis_names
    assert dict(jm.shape) == tm.shape
    assert [d.id for d in jm.devices.flat] == [d.index for d in tm.devices.flat]


@pytest.mark.parametrize("data, model, seq", [(16, 1, 1), (3, 3, 1), (0, 1, 1), (2, 2, 4), (None, 16, 1)])
def test_create_mesh_errors_match_jax(data, model, seq):
    with pytest.raises(ValueError) as jerr:
        jmesh.create_mesh(data=data, model=model, seq=seq)
    with pytest.raises(ValueError) as terr:
        tmesh.create_mesh(data=data, model=model, seq=seq, devices=cpu(8))
    assert str(terr.value) == str(jerr.value)


def test_create_mesh_defaults_and_cli_devices():
    """The default devices are the CUDA cards (none here); the CLIs' are the
    devices of --device's type, so a mesh of 2 on the CPU is refused with
    the JAX message."""
    assert tmesh.device_list("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="mesh 0x1x1 needs 1 devices, have 0"):
        tmesh.create_mesh()
    with pytest.raises(ValueError, match="mesh 2x1x1 needs 2 devices, have 1"):
        tgen.cli_mesh(2, 1, "cpu")
    assert tgen.cli_mesh(1, 1, "cpu") is None
    grid = tmesh.create_mesh(data=2, model=2, seq=2, devices=cpu(8))
    assert grid.tp_groups() == [[torch.device("cpu")] * 2] * 2 and grid.size == 8
    assert "over 1 distinct device" in str(grid)


# ------------------------------------------------------------- param_specs against JAX


def _jax_tree(kind):
    params = JaxF5TTS.init(jax.random.key(0), JaxDiTConfig(**TINY, use_flash_attention=False)).params
    return {"float": lambda p: p, "int4": lambda p: quantize_tree(p, 4), "w8a8": w8a8_blocks}[kind](params)


@pytest.mark.parametrize("kind", ["float", "int4", "w8a8"])
def test_param_specs_match_jax(kind):
    """Every tensor of the tree is sharded along the dim JAX's `param_specs`
    gives, mapped through `params_from_jax`: each JAX leaf becomes the index
    along its sharded dim (zeros where it is replicated), so after the
    conversion's transposes the port's sharded dim must carry the same
    index."""
    tree = jax.tree.map(np.asarray, _jax_tree(kind))
    specs = jmesh.param_specs(tree)

    def marker(leaf, spec):
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        if "model" not in entries:
            return np.zeros(leaf.shape, np.float32)
        return np.indices(leaf.shape)[entries.index("model")].astype(np.float32)

    marked = jax.tree.map(marker, tree, specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    state = params_from_jax(marked, DiTConfig(**TINY))
    sharded = 0
    for name, spec in tmesh.param_specs(state).items():
        t = state[name]
        if "model" in spec:
            sharded += 1
            want = torch.from_numpy(np.indices(t.shape)[spec.index("model")].astype(np.float32))
        else:
            want = torch.zeros_like(t)
        assert torch.equal(t, want), name
    # a block's sharded tensors: float q/k/v/w1 weight and bias, to_out/w2 weight (10); int4 q/k/v/w1 codes,
    # scales, biases and bias, to_out/w2 codes, scales and biases (22); W8A8 q/k/v/w1 w8, w8_scale and bias,
    # to_out/w2 w8 (14)
    assert sharded == {"float": 10, "int4": 22, "w8a8": 14}[kind] * TINY["depth"]

    # the port's own modules carry the same names
    dit = DiT(DiTConfig(**TINY))
    if kind == "int4":
        quantize_module_(dit, None)
    elif kind == "w8a8":
        w8a8_blocks_(dit)
    assert tmesh.param_specs(dit) == tmesh.param_specs(state)


# ------------------------------------------------------------- sampling


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX suite's mesh-serving model and the port's with its weights."""
    jax_model = JaxF5TTS.init(
        jax.random.key(0), JaxDiTConfig(**TINY, use_flash_attention=False), cfm_cfg=JaxCFMConfig(duration_bucket=64),
        vocoder=JaxVocos.init(jax.random.key(1), JaxVocosConfig(**VOCOS)).decode,
    )

    def port():
        dit = DiT(DiTConfig(**TINY))
        dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_model.params), DiTConfig(**TINY)))
        vocos = Vocos(VocosConfig(**VOCOS))
        vocos.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, jax_model._vocoder.__self__.params), VocosConfig(**VOCOS)))
        return F5TTS(dit, DiTConfig(**TINY), cfm_cfg=CFMConfig(duration_bucket=64), vocoder=vocos)

    return jax_model, port


def test_dp_tp_sample_matches_jax_use_mesh(jax_pair):
    """4 x 2 through `use_mesh` on both sides: an odd batch (the padding
    path), per-item durations, the same y0."""
    jax_model, port = jax_pair
    y0 = np.random.default_rng(9).standard_normal((3, 192, 100)).astype(np.float32)
    ref, ref_traj = jax_model.use_mesh(jmesh.create_mesh(data=4, model=2)).sample(
        jnp.asarray(_cond()), TEXTS, duration=DURS, steps=2, method="euler", y0=jnp.asarray(y0))
    sharded = port().use_mesh(tmesh.create_mesh(data=4, model=2, devices=cpu(8)))
    tmesh.all_reduce.counts.update(sum=0, max=0)
    got, traj = sharded.sample(_cond(), TEXTS, duration=DURS, steps=2, method="euler", y0=y0)
    # one flow evaluation: 4 data rows x 2 blocks x (attention, feed-forward)
    assert tmesh.all_reduce.counts == {"sum": 16, "max": 0}
    assert got.shape == ref.shape and traj.shape == ref_traj.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(traj.numpy(), np.asarray(ref_traj), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("grid", [dict(data=4), dict(data=2, model=2)])
def test_cfg_interval_branch_under_a_mesh(grid):
    """The guidance-interval branch (`cfm_sample_segmented`) splits over the
    data rows as the fused one does: the noise is drawn for the padded batch
    before the split, so every row samples what it samples alone."""
    kw = dict(steps=6, cfg_interval=(0.2, 0.8))
    ref, ref_traj = _sample(_port_model(), **kw)
    sharded = _port_model().use_mesh(tmesh.create_mesh(devices=cpu(4), **grid))
    got, traj = _sample(sharded, **kw)
    assert got.shape == ref.shape and traj.shape == ref_traj.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(traj.numpy(), ref_traj.numpy(), atol=1e-5, rtol=0)


def test_int4_under_model_parallelism():
    """K3's plain version at the shard shapes: codes, group scales and
    biases sliced along the output of to_q/k/v and w1 and along the input
    (groups alongside) of to_out and w2, whose bias is added once."""
    base = _port_model(WIDE)
    quantize_module_(base.dit, 4)
    ref, _ = _sample(base)
    sharded = _port_model(WIDE)
    quantize_module_(sharded.dit, 4)
    groups = sharded.use_mesh(tmesh.create_mesh(data=2, model=2, devices=cpu(4)))._inference_dit()
    shard = groups[0][0].shards[1]
    assert isinstance(shard.transformer_blocks[0].attn.to_out[0], QuantizedLinear)
    assert tuple(shard.transformer_blocks[0].attn.to_out[0].q.shape) == (256, 128)
    assert tuple(shard.transformer_blocks[0].attn.to_out[0].scales.shape) == (256, 2)
    assert tuple(shard.transformer_blocks[0].ff.ff[0][0].q.shape) == (256, 256)
    assert shard.transformer_blocks[0].attn.heads == 2
    got, _ = _sample(sharded)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=0)


def test_int4_shard_widths_must_stay_whole_groups():
    model = _port_model()
    quantize_module_(model.dit, 4)
    with pytest.raises(ValueError, match="groups of 64 along its 64 inputs"):
        model.use_mesh(tmesh.create_mesh(model=2, devices=cpu(2)))


@pytest.mark.parametrize("module, ways, message", [
    (lambda: torch.nn.ModuleDict({"attn": Attention(64, 3, 16)}), 2, "3 heads"),
    (lambda: torch.nn.ModuleDict({"ff": FeedForward(64, mult=1)}), 3, "64 hidden units")])
def test_shard_refuses_uneven_splits(module, ways, message):
    with pytest.raises(ValueError, match=message):
        shard_module(module(), tmesh.create_mesh(model=ways, devices=cpu(ways)))


def test_w8a8_under_2x2_is_bit_exact():
    """W8A8 under 2 x 2 against W8A8 unsharded: the column-parallel linears
    quantize whole rows, the row-parallel ones against the group's max of
    the slots' row absmax, and the int32 products sum exactly, so the
    sample and one DiT group forward equal the unsharded ones to the bit."""
    def w8(model):
        model.dit_cfg = model.dit_cfg.replace(int8_compute=True)
        return model

    ref_model = w8(_port_model())
    ref, ref_traj = _sample(ref_model)
    sharded = w8(_port_model()).use_mesh(tmesh.create_mesh(data=2, model=2, devices=cpu(4)))
    tmesh.all_reduce.counts.update(sum=0, max=0)
    got, traj = _sample(sharded)
    assert tmesh.all_reduce.counts == {"sum": 8, "max": 8}
    assert torch.equal(got, ref) and torch.equal(traj, ref_traj)

    # one forward of a single tensor-parallel group on the whole batch
    group = w8(_port_model()).use_mesh(tmesh.create_mesh(model=2, devices=cpu(2)))._inference_dit()[0][0]
    dit = ref_model._inference_dit()
    g = torch.Generator().manual_seed(3)
    x, cond = torch.randn(2, 64, 100, generator=g), torch.randn(2, 64, 100, generator=g)
    text = torch.randint(0, 255, (2, 20), generator=g)
    mask = torch.arange(64)[None] < torch.tensor([[64], [40]])
    mods = {k: v[0] for k, v in dit.time_mods(torch.tensor([0.3])).items()}
    te = dit.embed_text(text, 64)
    assert torch.equal(group(x, cond, te, mods, mask=mask), dit(x, cond, te, mods, mask=mask))


def _row_owner(layer):
    """`layer` at the name of a row-parallel linear (attn.to_out.0)."""
    return torch.nn.ModuleDict({"attn": torch.nn.ModuleDict({"to_out": torch.nn.ModuleList([layer])})})


@pytest.mark.parametrize("kind", ["float", "int4", "w8a8"])
def test_row_parallel_bias_is_added_once(kind):
    """A row-parallel linear with a large bias under model 2: each slot's
    partial leaves the bias out, and the reduced sum gets it once (twice
    would be off by the bias, 4.0 here)."""
    g = torch.Generator().manual_seed(1)
    lin = torch.nn.Linear(128, 32)
    with torch.no_grad():
        lin.bias.fill_(4.0)
    layer = {"float": lambda: lin, "int4": lambda: QuantizedLinear.from_linear(lin, 4),
             "w8a8": lambda: W8A8Linear.from_linear(lin)}[kind]()
    x = torch.randn(2, 10, 128, generator=g)
    shards = shard_module(_row_owner(layer), tmesh.create_mesh(model=2, devices=cpu(2)))[0]
    before = dict(tmesh.all_reduce.counts)
    with torch.no_grad():
        got = tmesh.lockstep([row_parallel(s["attn"]["to_out"][0], part)
                              for s, part in zip(shards, x.chunk(2, dim=-1))])
        ref = layer(x)
    counted = {k: v - before[k] for k, v in tmesh.all_reduce.counts.items()}
    assert counted == {"sum": 1, "max": 1 if kind == "w8a8" else 0}
    for y in got:
        if kind == "w8a8":
            assert torch.equal(y, ref)
        else:
            np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5, rtol=0)


def test_attention_shards_run_in_lockstep():
    """An attention split over 2 slots (one head each) against the whole
    one, with a key mask and RoPE: the heads are independent, so only the
    to_out sum is taken in another order."""
    torch.manual_seed(0)
    attn = Attention(64, 2, 32)
    x = torch.randn(2, 16, 64)
    mask = torch.arange(16)[None] < torch.tensor([[16], [9]])
    from f5_tts_tpu_torch.models.rope import rotary_freqs

    raw = rotary_freqs(16, 32)
    rope = (torch.cos(raw), torch.sin(raw))
    owner = torch.nn.ModuleDict({"attn": attn})  # the rules' names: attn.to_q, ...
    shards = [s["attn"] for s in shard_module(owner, tmesh.create_mesh(model=2, devices=cpu(2)))[0]]
    assert [s.heads for s in shards] == [1, 1] and tuple(shards[1].to_q.weight.shape) == (32, 64)
    got = tmesh.lockstep([s.steps(x, mask, rope) for s in shards])
    with torch.no_grad():
        ref = attn(x, mask, rope)
    np.testing.assert_allclose(got[0].detach().numpy(), ref.numpy(), atol=1e-6, rtol=0)
    with pytest.raises(RuntimeError, match="lockstep"):
        shards[0](x, mask, rope)  # a shard does not run alone


def test_w8a8_row_kernels_plain_versions():
    """`row_absmax` and `quantize_scaled` (plain on the CPU) split
    `quantize_rows`: the max of two column halves' absmax quantizes each half
    to the whole row's codes; rows past m hold zero codes."""
    x = torch.randn(5, 128, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    codes, sx = W.quantize_rows(x, 32)
    amax = torch.maximum(*(W.row_absmax(h) for h in x.chunk(2, dim=-1)))
    halves = [W.quantize_scaled(h.contiguous(), amax, 32) for h in x.chunk(2, dim=-1)]
    assert torch.equal(torch.cat([h[0] for h in halves], dim=-1), codes)
    assert all(torch.equal(h[1], sx) for h in halves)
    assert not codes[5:].any()


def test_seq_slots_hold_replicas():
    """A seq axis replicates the parameters for sampling: 2 x 2 x 2 samples
    what 2 x 2 does, on the same data rows and tensor-parallel groups."""
    grid = tmesh.create_mesh(data=2, model=2, seq=2, devices=cpu(8))
    assert [len(g.shards) for g, _ in _port_model().use_mesh(grid)._inference_dit()] == [2, 2]
    got, _ = _sample(_port_model().use_mesh(grid))
    ref, _ = _sample(_port_model().use_mesh(tmesh.create_mesh(data=2, model=2, devices=cpu(4))))
    assert torch.equal(got, ref)


def test_a_sampler_over_a_mesh_does_not_export():
    from f5_tts_tpu_torch import export

    model = _port_model().use_mesh(tmesh.create_mesh(data=2, devices=cpu(2)))
    with pytest.raises(ValueError, match="over a mesh"):
        export.export_sampler(model, batch=1, steps=2, method="euler")


def test_batch_pad_split_gather():
    t = torch.arange(6).view(3, 2)
    padded = tmesh.pad_batch(t, 4)
    assert padded.tolist() == [[0, 1], [2, 3], [4, 5], [0, 1]]
    assert tmesh.pad_batch(t, 3) is t
    parts = tmesh.split_batch(padded, cpu(2))
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [0, 1]]]
    assert torch.equal(tmesh.gather_batch(parts, torch.device("cpu"), 3), t)


def test_use_mesh_keeps_the_master_and_rebuilds_on_change():
    model = _port_model()
    master = model.dit.transformer_blocks[0].attn.to_q.weight
    rows = model.use_mesh(tmesh.create_mesh(data=2, model=2, devices=cpu(4)))._inference_dit()
    assert model.dit.transformer_blocks[0].attn.to_q.weight is master and master.shape == (64, 64)
    assert len(rows) == 2 and all(len(g.shards) == 2 for g, _ in rows)
    assert model._inference_dit() is rows
    with torch.no_grad():
        master.add_(1.0)
    assert model._inference_dit() is not rows


# ------------------------------------------------------------- entry points


def _synthesize(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read()
    with wave_mod.open(io.BytesIO(body)) as w:
        assert w.getframerate() == 24_000
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")


PAYLOAD = {"text": "mesh serving equality check", "duration": 7.0, "steps": 2, "method": "euler", "seed": 3}


def _served(model):
    httpd = serve(model, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=40.0)
    try:
        return _synthesize(httpd.server_address[1], PAYLOAD)
    finally:
        httpd.batcher.stop()
        httpd.shutdown()
        httpd.batcher.join(timeout=30)


def test_sharded_server_matches_unsharded():
    """As the JAX suite's check: a request to a server whose model samples
    over data 4 is the unsharded server's PCM within 2 LSB."""
    ref = _served(_port_model())
    got = _served(_port_model().use_mesh(tmesh.create_mesh(data=4, devices=cpu(4))))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2)


def test_generate_with_a_mesh_leaves_the_callers_model_unsharded(tmp_path):
    model = _port_model()
    cache = model._cast_cache
    tmesh.all_reduce.counts.update(sum=0, max=0)
    wave = tgen.generate("hi there", duration=1.0, model=model, play=False, steps=2, method="euler", seed=0,
                         mesh=tmesh.create_mesh(model=2, devices=cpu(2)), output_path=str(tmp_path / "o.wav"))
    assert np.isfinite(wave).all() and tmesh.all_reduce.counts["sum"] > 0
    assert model._mesh is None and model._cast_cache is cache
    assert model._inference_dit() is model.dit


def test_scaling_tool_on_the_cpu():
    """The port's `tools/scaling.py` sampling half: grids of 1, 2 and 4 slots
    sample what 1 slot does (float32 sums in another order), with two
    reductions a block a flow evaluation a data row."""
    from f5_tts_tpu_torch.tools import scaling

    rows = scaling.sampling_rows([1, 2, 4], "cpu")
    evals, depth = scaling.STEPS - 1, scaling.CFG.depth
    assert [r["reductions"]["sum"] for r in rows] == [0, 2 * depth * evals, 2 * 2 * depth * evals]
    assert all(r["max_abs_delta"] < 1e-5 for r in rows)
