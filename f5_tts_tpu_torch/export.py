"""AOT deployment artifacts: the sampling pipeline and the duration
predictor as `torch.export` programs (the port of the JAX package's
`export.py`).

`export_sampler` traces the whole serving computation of `F5TTS.sample`
(conditioning, the ODE over the DiT with CFG, the composite with the
reference and Vocos; `models/cfm.py` `cfm_sample_e2e`) for one
(batch, padded_len, steps) bucket into an `ExportedProgram`. The time grid
is an input, so one artifact serves any sway coefficient, and the true
longest duration is a 0-d input, so it serves every utterance that fits its
bucket. The ODE steps unroll into the graph. The kernels on that path (K1,
K1-f32, K3 and the W8A8 linear's two) are registered torch operators
(ops/), so the program calls them by name: a serving host loads and runs it
with this package's `ops` and host utilities, and without the model code,
the weights' snapshot or the tokenizer assets. No decomposition runs on
the program, so it calls the same aten operators as the live path.

The file (`save_sampler`, `load_sampler`) is this package's own container:
the magic `F5T1`, a length-prefixed JSON header (the audio constants, the
device type, the noise rule, and for `embed_weights=False` the weights'
layout), the raw weights, then the `torch.export.save` bytes. It is not the
JAX package's `F5X1` StableHLO container, and each loader refuses the
other's files.

Differences from the JAX module, each deliberate:
  - Noise. A generator cannot live in the graph, so the program takes the
    initial noise y0 [b, padded_len, mel] as its last input. The loader's
    `.call` keeps the JAX contract, `.call(*prep_inputs(spec, ...,
    seed=s))` with the 7 arguments (cond, lens, duration, max_dur, text,
    ts, seed), and draws y0 from the seed outside the program with the
    live path's generator call (`utils/sampling.py` `draw_noise`, with the
    header's `shared_noise`): an artifact call at seed s starts from the
    same noise as `F5TTS.sample(seed=s)` at the same bucket.
  - Device. A program is exported for one device type, which the header
    records; `load_sampler` loads it onto the card by default, and onto
    another device type only when the caller names it (the program is then
    moved with `torch.export.passes.move_to_device_pass`). The operators
    dispatch on their inputs' device, so a program exported on the CPU and
    moved to the card launches the kernels.
  - `use_flash=False` (`--no-flash`) raises ValueError: the JAX flag lowers
    attention without Pallas to make a program portable, which the
    operators already are, and the port runs no plain attention on the
    card.
  - Placement over a mesh. The JAX `.call` re-traces into the serving
    runtime, where GSPMD partitions the program over sharded inputs. The
    port has no partitioner, so a sampler of batch B >= 2 is exported with
    a symbolic batch (`torch.export.Dim`, 1 to B; the header records B,
    which the program's input shapes no longer carry), and
    `place_weights(mesh)` keeps one program and one weight copy per
    distinct device of the mesh's data rows. A call then draws the noise
    for the B rows as a one-device call does (first, on the first row's
    device), pads every batched argument, the noise included, with copies
    of row 0 to a multiple of "data" (`parallel/mesh.py` `pad_batch`),
    runs each data row's program on its share and joins the rows on the
    first row's device, trimmed to B. Drawing before padding keeps the
    one-device call the yardstick: a draw over more rows need not give the
    same first B rows on the card. A mesh with a "model" axis above 1 is
    refused (a `torch.export` program is not tensor-partitioned; the live
    `F5TTS.use_mesh` serves tensor parallelism), and so is a file written
    with a static batch of 2 or more on more than one data row.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

# the registered operators must exist before a program that calls them is loaded
from f5_tts_tpu_torch.ops import flash_attention as _k1  # noqa: F401
from f5_tts_tpu_torch.ops import qmatmul as _k3  # noqa: F401
from f5_tts_tpu_torch.ops import w8a8 as _n2  # noqa: F401
from f5_tts_tpu_torch.parallel.mesh import Mesh, gather_batch, pad_batch, split_batch
from f5_tts_tpu_torch.utils.sampling import clamp_duration, draw_noise, sway_time_grid

_MAGIC = b"F5T1"
_JAX_MAGIC = b"F5X1"

# the fixed device-argument signature of every sampler: (cond, lens, duration, max_dur, text, ts, seed);
# the program takes y0 in the place of seed
_N_CALL_ARGS = 7
# the program's arguments with a batch dimension: cond, lens, duration, text, y0 (max_dur and ts are shared)
_BATCHED = (0, 1, 2, 4, 6)

# the fixed device-argument signature of every duration predictor: (cond, text, lens)
_N_DURATION_ARGS = 3

# SamplerSpec fields load_sampler takes from the program's input shapes, never from the header
_DERIVED_SPEC_FIELDS = {"batch", "padded_len", "steps", "mel_dim"}

# header fields the exporter writes itself ("batch": a symbolic batch leaves it out of the input shapes)
_CONTRACT_FIELDS = {"format", "weights", "kind", "device", "shared_noise", "batch"}

USE_FLASH_REFUSED = (
    "use_flash=False (--no-flash) is not supported by the PyTorch port: the JAX flag lowers attention "
    "without Pallas so that an artifact runs on several platforms, and the port's artifacts already do (the "
    "attention kernel is a registered operator that dispatches on its inputs' device; load with device=). "
    "The port never runs plain attention on the card."
)


@dataclass
class Exported:
    """An exported program and what its call contract needs beside the
    graph: `meta` holds the header fields the exporter decides ("kind",
    "device", and "shared_noise" for a sampler)."""

    program: torch.export.ExportedProgram
    meta: dict

    def input_shapes(self) -> list[tuple]:
        """The shapes of the program's inputs in order, the weights'
        first for `embed_weights=False`."""
        return [tuple(v.shape) for v in _user_inputs(self.program)]


class _SamplerProgram(nn.Module):
    """The traced computation of one sampler: `cfm_sample_e2e` with the
    noise as an input, returning (mel, wave), or the mel alone without a
    vocoder."""

    def __init__(self, dit: nn.Module, vocoder: nn.Module | None, method: str, cfg_strength: float):
        super().__init__()
        self.dit = dit
        self.vocoder = vocoder
        self.method = method
        self.cfg_strength = cfg_strength

    def forward(self, cond, lens, duration, max_dur, text, ts, y0):
        from f5_tts_tpu_torch.models.cfm import cfm_sample_e2e

        out, _, wave = cfm_sample_e2e(
            self.dit, cond, lens, duration, max_dur, text, ts, y0, 0, self.vocoder, method=self.method,
            cfg_strength=self.cfg_strength, return_trajectory=False, shared_noise=False,
        )
        return (out, wave) if wave is not None else out


class _DurationProgram(nn.Module):
    def __init__(self, predictor: nn.Module):
        super().__init__()
        self.predictor = predictor

    def forward(self, cond, text, lens):
        return self.predictor.seconds(cond, text, lens)


class _WeightsAsInput(nn.Module):
    """`inner` with its parameters and buffers as a leading dict argument
    (`torch.func.functional_call`): `inner` is held outside the module tree,
    so the exported program carries no weights."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self._inner = (inner,)

    def forward(self, weights, *args):
        return torch.func.functional_call(self._inner[0], weights, args)


def _weights(module: nn.Module) -> dict:
    """Every parameter and buffer of `module` by name, in module order."""
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


@contextlib.contextmanager
def _no_stack_traces():
    """Record no Python stack trace on the traced nodes (torch.fx.config's
    switch, where this torch has it): an unrolled sampler has tens of
    thousands of nodes, whose traces slow the export and make up about
    half of the saved graph."""
    config = torch.fx.config
    old = getattr(config, "do_not_emit_stack_traces", None)
    if old is not None:
        config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        if old is not None:
            config.do_not_emit_stack_traces = old


def _export(module: nn.Module, args: tuple, embed_weights: bool, dynamic: tuple | None = None
            ) -> torch.export.ExportedProgram:
    """`dynamic`: one `dynamic_shapes` entry an argument of `args`, or None
    for static shapes."""
    if not embed_weights:
        weights = _weights(module)
        module, args = _WeightsAsInput(module), (weights, *args)
        dynamic = None if dynamic is None else ({k: None for k in weights}, dynamic)  # forward(weights, *args)
    with torch.no_grad(), _no_stack_traces():
        program = torch.export.export(module, args, dynamic_shapes=dynamic, strict=False)
    program.example_inputs = None  # else torch.export.save writes them too: for external weights, a second copy
    return program


def _device_of(module: nn.Module, device) -> torch.device:
    here = next(module.parameters()).device
    want = here if device is None else torch.device(device)
    if want.type != here.type or want.index not in (None, here.index):
        raise ValueError(f"the model is on {here}, not {device}: export on the model's device (an artifact "
                         "loads onto another device with load_sampler(path, device=...))")
    return here


def _sampler_program(model, with_vocoder: bool, method: str, cfg_strength: float) -> _SamplerProgram:
    if model._mesh is not None:
        raise ValueError("a sampler over a mesh (use_mesh) does not export: export the model without its mesh")
    return _SamplerProgram(model._inference_dit(), model.vocoder if with_vocoder else None, method,
                           float(cfg_strength))


def export_sampler(
    model,
    *,
    batch: int,
    padded_len: int | None = None,
    steps: int = 8,
    method: str = "rk4",
    cfg_strength: float = 2.0,
    shared_noise: bool = True,
    with_vocoder: bool = True,
    use_flash: bool | None = None,
    embed_weights: bool = True,
    device=None,
) -> Exported:
    """Export one (batch, padded_len, steps) sampling bucket of `model` (an
    `F5TTS`, on `device`, by default wherever it is). The program's
    signature is

        (cond f32[b, L, d], lens i32[b], duration i32[b], max_dur i32[],
         text i32[b, L], ts f32[steps], y0 f32[b, L, d])
            -> (mel f32[b, L, d], wave f32[b, (L-1)*hop])   # or mel only

    and the loader's `.call` takes the JAX signature, with seed i32[] in the
    place of y0 (see the module's note). `shared_noise=True` gives every
    batch row the same noise, as `sample(seed=...)` does. `padded_len`
    defaults to one duration bucket and is rounded up to a multiple of one.
    The sampler runs the model's inference copy of the DiT (bf16, or W8A8
    with `dit_cfg.int8_compute`), as `sample` does.

    `embed_weights=False` exports the weights (every parameter and buffer of
    the DiT copy and the vocoder) as a leading dict argument instead of
    program state; `save_sampler` then stores them beside the program and
    `load_sampler` binds them again (`BoundSampler`).

    A `batch` of 2 or more is a symbolic dimension of the program (1 to
    `batch`), so that the data rows of a mesh each run their share of the
    rows (`LoadedProgram.place_weights`); a batch-1 bucket stays static."""
    if use_flash is False:
        raise ValueError(USE_FLASH_REFUSED)
    from f5_tts_tpu_torch.models.ode import METHODS

    if method not in METHODS:
        raise ValueError(f"Unknown method: {method}; expected one of {METHODS}")
    if steps < 2:
        raise ValueError(f"steps must be at least 2 (a grid of {steps} points has no interval)")
    dev = _device_of(model.dit, device)
    bucket = model.cfm_cfg.duration_bucket
    padded_len = bucket if padded_len is None else math.ceil(padded_len / bucket) * bucket
    d = model.dit_cfg.mel_dim
    if with_vocoder and model.vocoder is None:
        raise ValueError("the model has no vocoder: pass with_vocoder=False for a mel-only artifact")
    program = _sampler_program(model, with_vocoder, method, cfg_strength)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    args = (zeros(batch, padded_len, d), zeros(batch, dtype=torch.int32), zeros(batch, dtype=torch.int32),
            zeros(dtype=torch.int32), zeros(batch, padded_len, dtype=torch.int32), zeros(steps),
            zeros(batch, padded_len, d))
    dynamic = None
    if batch >= 2:
        rows = {0: torch.export.Dim("batch", min=1, max=batch)}
        dynamic = tuple(rows if i in _BATCHED else None for i in range(len(args)))
    return Exported(_export(program, args, embed_weights, dynamic),
                    {"kind": "sampler", "device": str(dev), "shared_noise": bool(shared_noise), "batch": batch})


def _user_inputs(program: torch.export.ExportedProgram) -> list:
    """The program's user inputs, flattened (the weights' leaves first for
    `embed_weights=False`), as fake tensors."""
    names = set(program.graph_signature.user_inputs)
    return [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder" and n.name in names]


def _n_inputs(exported: Exported) -> int:
    return len(exported.program.graph_signature.user_inputs)


def _weight_blobs(weights: dict, exported: Exported, n_args: int, what: str) -> tuple[list, list]:
    """The header layout and the raw bytes of `weights`, checked leaf by leaf
    against the program's leading inputs."""
    leaves = list(weights.values())
    avals = _user_inputs(exported.program)[:len(leaves)]
    n_w = _n_inputs(exported) - n_args
    if len(leaves) != n_w or any(leaf.shape != a.shape or leaf.dtype != a.dtype for leaf, a in zip(leaves, avals)):
        raise ValueError(f"{what} weights do not match the artifact's weight inputs ({n_w} leading inputs); "
                         f"was the artifact exported from this {what}?")
    layout, blobs = [], []
    for name, t in weights.items():
        # a parameter binds again as one: torch.matmul folds its operands differently when one requires grad,
        # so the program's numbers equal the live model's only if each weight is what it was there
        entry = {"name": name, "parameter": isinstance(t, nn.Parameter)}
        t = t.detach().contiguous().cpu()
        layout.append({**entry, "dtype": str(t.dtype).removeprefix("torch."), "shape": list(t.shape)})
        # raw words of any dtype, bf16 included (numpy has none)
        blobs.append(t.view(torch.uint8).numpy() if t.numel() else b"")
    return layout, blobs


def save_sampler(exported: Exported, path, *, model=None, extra_meta: dict | None = None) -> None:
    """Write a sampler artifact: the header (the model's audio constants
    and vocabulary size, the device type, the noise rule, `extra_meta`'s
    informational fields such as {"method": "rk4", "cfg_strength": 2.0}),
    for `embed_weights=False` exports the weights (which need `model`),
    then the program. Without `model` the header carries no audio constants
    and loaders assume the 24 kHz defaults, with a warning here. Keys the
    loader derives from the program or the exporter writes are reserved in
    `extra_meta`."""
    if exported.meta.get("kind") != "sampler":
        raise ValueError(f"save_sampler takes a sampler export, not a {exported.meta.get('kind')!r} one "
                         "(duration artifacts save with save_duration)")
    meta = dict(extra_meta or {})
    bad = (_DERIVED_SPEC_FIELDS | _CONTRACT_FIELDS) & meta.keys()
    if bad:
        raise ValueError(f"extra_meta keys {sorted(bad)} are reserved: load_sampler derives them from the "
                         "program's input shapes / the file format")
    if model is not None:
        meta.update(hop_length=model.audio_cfg.hop_length, sample_rate=model.audio_cfg.sample_rate,
                    max_duration=model.cfm_cfg.max_duration, text_num_embeds=model.dit_cfg.text_num_embeds)
    else:
        warnings.warn(
            "save_sampler called without model=: the artifact header will carry no audio constants or vocab "
            "size, so loaders assume 24 kHz / hop 256 defaults and skip text-id range validation. Pass the "
            "model unless it uses the default AudioConfig.",
            stacklevel=2,
        )
    meta.update({k: v for k, v in exported.meta.items() if k != "kind"})
    blobs: list = []
    if _n_inputs(exported) > _N_CALL_ARGS:
        if model is None:
            raise ValueError("this artifact was exported with embed_weights=False; save_sampler needs model= "
                             "to store the weights payload")
        n_w = _n_inputs(exported) - _N_CALL_ARGS
        # the vocoder's weights follow the DiT's: a mel-only export has fewer leading inputs
        candidates = [_weights(_sampler_program(model, v, "euler", 0.0))
                      for v in ((True, False) if model.vocoder is not None else (False,))]
        weights = next((w for w in candidates if len(w) == n_w), candidates[-1])
        meta["weights"], blobs = _weight_blobs(weights, exported, _N_CALL_ARGS, "model")
    _write_container(path, meta, blobs, exported.program)


def _write_container(path, meta: dict, weight_blobs: list, program: torch.export.ExportedProgram) -> None:
    """The container: MAGIC, length-prefixed JSON header, raw weight blobs
    (layout in the header), the `torch.export.save` bytes."""
    header = json.dumps({"format": 1, **meta}).encode()
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with open(path, "wb") as f:
        f.write(_MAGIC + len(header).to_bytes(4, "little") + header)
        for blob in weight_blobs:
            f.write(blob)
        f.write(buf.getbuffer())


def _read_container(path):
    """Inverse of `_write_container`. Returns (meta, weights | None,
    program); `format` and `weights` are consumed here. A JAX artifact, or
    anything else without the magic, raises ValueError."""
    with open(path, "rb") as f:
        blob = bytearray(os.fstat(f.fileno()).st_size)  # writable, so the weights are views of it
        f.readinto(blob)
    if blob[:4] == _JAX_MAGIC:
        raise ValueError(f"{path} is a JAX package artifact (F5X1, a StableHLO program for "
                         "f5_tts_tpu.export.load_sampler); the PyTorch port loads its own F5T1 artifacts "
                         "(f5_tts_tpu_torch.export)")
    if blob[:4] != _MAGIC:
        raise ValueError(f"{path} is not an f5_tts_tpu_torch artifact (no F5T1 header)")
    hlen = int.from_bytes(blob[4:8], "little")
    meta = json.loads(blob[8:8 + hlen].decode())
    fmt = meta.pop("format", None)
    if fmt != 1:
        raise ValueError(f"unsupported artifact header format {fmt!r} (this loader understands format 1)")
    pos = 8 + hlen
    weights = None
    layout = meta.pop("weights", None)
    if layout:
        weights = {}
        for entry in layout:
            dtype = getattr(torch, entry["dtype"])
            count = math.prod(entry["shape"])
            leaf = torch.frombuffer(blob, dtype=dtype, count=count, offset=pos) if count else \
                torch.empty(0, dtype=dtype)
            leaf = leaf.view(entry["shape"])
            weights[entry["name"]] = nn.Parameter(leaf, requires_grad=leaf.is_floating_point()) \
                if entry["parameter"] else leaf
            pos += count * leaf.element_size()
    program = torch.export.load(io.BytesIO(memoryview(blob)[pos:]))
    return meta, weights, program


def _placed(program: torch.export.ExportedProgram, meta: dict, path, device) -> tuple:
    """The program on the requested device: `device=None` is the card, and
    a device type other than the exported one must be named."""
    if "device" not in meta:
        raise ValueError(f"{path}: the header records no device")
    exported_on = torch.device(meta.pop("device"))
    target = torch.device("cuda" if device is None else device)
    if target.type != exported_on.type and device is None:
        raise ValueError(f"{path} was exported for {exported_on.type}; load it with device={exported_on.type!r}, "
                         "or name the device to move it to (device='cuda')")
    if target.type == "cuda" and target.index is None:
        target = torch.device("cuda", torch.cuda.current_device())
    if target != exported_on:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, str(target))
    return program, target


@dataclass(frozen=True)
class SamplerSpec:
    """The host-side knowledge a deployment needs next to the artifact:
    the bucket from the program's input shapes, the audio constants from
    the header (24 kHz defaults without one)."""

    batch: int
    padded_len: int
    steps: int
    mel_dim: int
    hop_length: int = 256
    sample_rate: int = 24_000
    max_duration: int = 4096
    # vocabulary size for the text-id range check (None: written without model=, no check)
    text_num_embeds: int | None = None
    # informational: the ODE method and CFG strength in the program (save_sampler's extra_meta)
    method: str | None = None
    cfg_strength: float | None = None


class LoadedProgram:
    """A loaded artifact. `.call(*args)` takes the device arguments as
    numpy arrays or tensors, puts them on the program's device in the
    program's dtypes and runs it under `torch.inference_mode`; a sampler's
    `.call` takes the seed in the program's last place and draws the noise
    (see the module's note).

    `place_weights(target)` moves the program once: to a device, or, for a
    sampler, over the data rows of a `parallel/mesh.py` `Mesh` (one program
    a distinct device; each call splits the batch over the rows, see the
    module's note). It returns self."""

    def __init__(self, program: torch.export.ExportedProgram, device: torch.device, n_args: int,
                 noise: dict | None):
        self.program = program
        self.device = device
        self._noise = noise  # {"shared": bool} for a sampler, None for a duration predictor
        self._programs = {device: program}
        self._modules = {device: program.module()}
        self._rows: list[torch.device] | None = None  # the data rows' devices after place_weights(mesh)
        self._dtypes = [v.dtype for v in _user_inputs(program)[-n_args:]]

    def _weights(self, device=None) -> tuple:
        return ()

    def _keep_weights(self, devices: list) -> None:
        pass

    def _place(self, devices: list, rows: list | None) -> None:
        """Keep one program a device of `devices`, each moved from the one
        on `self.device` (`move_to_device_pass` moves in place, so a copy of
        it where that one stays in use), then one weight copy each."""
        from torch.export.passes import move_to_device_pass

        source = self._programs[self.device]
        missing = [d for d in devices if d not in self._programs]
        for i, d in enumerate(missing):
            last_use = self.device not in devices and i == len(missing) - 1
            self._programs[d] = move_to_device_pass(source if last_use else copy.deepcopy(source), str(d))
            self._modules[d] = self._programs[d].module()
        self._programs = {d: self._programs[d] for d in devices}
        self._modules = {d: self._modules[d] for d in devices}
        self._rows, self.device = rows, devices[0] if rows is None else rows[0]
        self.program = self._programs[self.device]
        for d in devices:
            self._weights(d)
        self._keep_weights(devices)

    def place_weights(self, target) -> "LoadedProgram":
        """Place the program and its weights on a device, or over the data
        rows of a mesh (a sampler's); returns self."""
        if not isinstance(target, Mesh):
            device = torch.device(target)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self._place([device], None)
            return self
        if self._noise is None:
            raise ValueError("a duration artifact runs on one device: place it with a device, not a mesh")
        if target.shape["model"] > 1:
            raise ValueError(
                f"a {target} has a model axis of {target.shape['model']}: a torch.export program is not "
                "tensor-partitioned, so an artifact runs over data rows only (create_mesh(data=N)); the live "
                "F5TTS.use_mesh serves tensor parallelism")
        rows = [group[0] for group in target.tp_groups()]
        batch_dim = _user_inputs(self.program)[-_N_CALL_ARGS].shape[0]
        if len(rows) > 1 and isinstance(batch_dim, int) and batch_dim >= 2:
            raise ValueError(
                f"this artifact was exported with a static batch of {batch_dim}, so a data row cannot run a share "
                "of it: export it again (export_sampler gives a batch of 2 or more a symbolic dimension)")
        self._place(list(dict.fromkeys(rows)), rows)
        return self

    def _run(self, device: torch.device, args: list):
        weights = self._weights(device)
        if device.type == "cuda":
            with torch.cuda.device(device):
                return self._modules[device](*weights, *args)
        return self._modules[device](*weights, *args)

    def call(self, *args):
        dtypes = self._dtypes
        if self._noise is not None:
            *args, seed = args
            cond = args[0]
            b, length, d = cond.shape
            args.append(draw_noise(int(seed), self._noise["shared"], b, length, d, self.device))
        args = [torch.as_tensor(a, dtype=dt, device=self.device) for a, dt in zip(args, dtypes)]
        with torch.inference_mode():
            if self._rows is None:
                return self._run(self.device, args)
            rows = self._rows
            b = args[0].shape[0]
            parts = [split_batch(pad_batch(a, len(rows)), rows) if i in _BATCHED else [a.to(r) for r in rows]
                     for i, a in enumerate(args)]
            results = [self._run(r, [p[j] for p in parts]) for j, r in enumerate(rows)]
            if isinstance(results[0], torch.Tensor):
                return gather_batch(results, self.device, b)
            return tuple(gather_batch(list(out), self.device, b) for out in zip(*results))


class BoundSampler(LoadedProgram):
    """An `embed_weights=False` artifact bound again to its stored weights:
    `.call` takes the same device arguments as an embedded one. The weights
    move to the program's device once, on the first call, or when
    `place_weights` places the program: one copy a distinct device."""

    def __init__(self, program, device, n_args: int, noise, weights: dict):
        super().__init__(program, device, n_args, noise)
        self._weights_host = weights
        self._weights_dev: dict = {}  # device -> the weights there

    def _weights(self, device=None) -> tuple:
        device = self.device if device is None else device
        if device not in self._weights_dev:
            src = self._weights_host if self._weights_host is not None else next(iter(self._weights_dev.values()))
            # normal tensors even when the first call runs under inference mode (a server's batcher thread): the
            # card's matmuls took other kernels at batch 1 with inference-tensor weights than the live model's
            with torch.inference_mode(False):
                self._weights_dev[device] = {k: (nn.Parameter(v.to(device), v.requires_grad)
                                                 if isinstance(v, nn.Parameter) else v.to(device))
                                             for k, v in src.items()}
            self._weights_host = None
        return (self._weights_dev[device],)

    def _keep_weights(self, devices: list) -> None:
        self._weights_dev = {d: self._weights_dev[d] for d in devices}


def _loaded(program, weights, meta, path, device, n_args: int, noise):
    program, target = _placed(program, meta, path, device)
    n_w = len(program.graph_signature.user_inputs) - n_args
    if n_w != (0 if weights is None else len(weights)):
        raise ValueError(f"{path}: the artifact stores {0 if weights is None else len(weights)} weight leaves but "
                         f"the program expects {n_w}")
    if weights is None:
        return LoadedProgram(program, target, n_args, noise)
    return BoundSampler(program, target, n_args, noise, weights)


def _input_shapes(program) -> list[tuple]:
    return [tuple(v.shape) for v in _user_inputs(program)]


def load_sampler(path, device=None) -> tuple[LoadedProgram, SamplerSpec]:
    """Reload a sampler artifact onto `device` (the card by default; see
    the module's note); returns (sampler, spec). Run it as
    `sampler.call(*prep_inputs(spec, ...))`, which returns (mel, wave) on
    the device, or the mel of a mel-only artifact."""
    meta, weights, program = _read_container(path)
    kind = meta.pop("kind", None)
    if kind is not None:
        raise ValueError(f"{path} is a {kind!r} artifact, not a sampling artifact "
                         "(duration-predictor artifacts load via load_duration)")
    shared = meta.pop("shared_noise", None)
    if shared is None:
        raise ValueError(f"{path}: the header records no noise rule (shared_noise)")
    shapes = _input_shapes(program)
    (b, length, d), (steps,) = shapes[-7], shapes[-2]
    # a symbolic batch: the header records the bucket's (a file with a static batch may not)
    b = meta.pop("batch", b)
    if not isinstance(b, int):
        raise ValueError(f"{path}: the program's batch is symbolic and the header records none")
    sampler = _loaded(program, weights, meta, path, device, _N_CALL_ARGS, {"shared": bool(shared)})
    known = {f.name for f in dataclasses.fields(SamplerSpec)} - _DERIVED_SPEC_FIELDS
    meta = {k: v for k, v in meta.items() if k in known}
    return sampler, SamplerSpec(batch=b, padded_len=length, steps=steps, mel_dim=d, **meta)


def _check_text(spec, text_np: np.ndarray, what: str) -> None:
    if spec.text_num_embeds is not None and text_np.size and int(text_np.max()) >= spec.text_num_embeds:
        raise ValueError(f"text id {int(text_np.max())} out of range for the artifact's text_num_embeds="
                         f"{spec.text_num_embeds}; the tokenizer vocab does not match the exported {what}")


def _padded_cond(cond_mel, padded_len: int):
    """cond [b, n, d] zero-padded to padded_len frames: on its device for a
    tensor (the artifact server's mel stays on the card), else in numpy."""
    if isinstance(cond_mel, torch.Tensor):
        return torch.nn.functional.pad(cond_mel.float(), (0, 0, 0, padded_len - cond_mel.shape[1]))
    b, n, d = cond_mel.shape
    cond = np.zeros((b, padded_len, d), np.float32)
    cond[:, :n] = cond_mel
    return cond


def prep_inputs(
    spec: SamplerSpec,
    cond_mel,  # [b, n, d] float mel (<= padded_len frames), numpy or a tensor
    text_ids: np.ndarray,  # [b, nt] int ids padded with -1
    duration: np.ndarray | int,  # [b] or scalar total frames
    *,
    lens: np.ndarray | None = None,
    sway_sampling_coef: float | None = -1.0,
    seed: int = 0,
):
    """Host-side prep mirroring `F5TTS.sample` (the duration clamp, the
    padding, the sway time grid) for a loaded artifact: the 7 positional
    arguments of `.call`, (cond, lens, duration, max_dur, text, ts, seed).
    Tokenization happens upstream (ids, not strings, are the contract)."""
    if not isinstance(cond_mel, torch.Tensor):
        cond_mel = np.asarray(cond_mel, np.float32)
    b, n, d = cond_mel.shape
    if (b, d) != (spec.batch, spec.mel_dim) or n > spec.padded_len:
        raise ValueError(f"cond {tuple(cond_mel.shape)} does not fit artifact bucket "
                         f"[{spec.batch}, {spec.padded_len}, {spec.mel_dim}]")
    text_np = np.asarray(text_ids, np.int32)
    # the program's embedding gather clips, so an out-of-vocabulary id would silently alias the last row
    _check_text(spec, text_np, "model")
    lens_np = np.full((b,), n, np.int32) if lens is None else np.asarray(lens, np.int32)
    text_lens = (text_np != -1).sum(axis=-1).astype(np.int32)
    lens_np = np.maximum(text_lens, lens_np)
    if isinstance(duration, (int, np.integer)):
        duration = np.full((b,), duration, np.int32)
    duration = clamp_duration(duration, lens_np, text_lens, spec.max_duration)
    max_dur = int(duration.max())
    if max_dur > spec.padded_len:
        raise ValueError(f"max duration {max_dur} exceeds artifact bucket {spec.padded_len}")
    text = np.full((b, spec.padded_len), -1, np.int32)
    ncopy = min(text_np.shape[1], spec.padded_len)
    text[:, :ncopy] = text_np[:, :ncopy]
    ts = sway_time_grid(spec.steps, sway_sampling_coef).astype(np.float32)
    return (_padded_cond(cond_mel, spec.padded_len), lens_np, duration.astype(np.int32), np.int32(max_dur), text,
            ts, np.int32(seed))


# ---------------------------------------------------------------------------
# Duration-predictor artifacts: the trained predictor over one fixed
# (batch, padded_len) mel window, so that an artifact-only host resolves
# missing durations as the live server does.


def export_duration(
    predictor,
    *,
    batch: int = 1,
    padded_len: int,
    use_flash: bool | None = None,
    embed_weights: bool = True,
    device=None,
) -> Exported:
    """Export the duration predictor over one fixed mel window:

        (cond f32[b, L, mel], text i32[b, L], lens i32[b]) -> seconds f32[b]

    the padded-window contract of the live server (frames past `lens` are
    masked and left out of the mean; `DurationPredictor.seconds`).
    `embed_weights=False` works as in `export_sampler`."""
    if use_flash is False:
        raise ValueError(USE_FLASH_REFUSED)
    dev = _device_of(predictor, device)
    args = (torch.zeros(batch, padded_len, predictor.cfg.mel_dim, device=dev),
            torch.zeros(batch, padded_len, dtype=torch.int32, device=dev),
            torch.zeros(batch, dtype=torch.int32, device=dev))
    return Exported(_export(_DurationProgram(predictor), args, embed_weights),
                    {"kind": "duration", "device": str(dev)})


@dataclass(frozen=True)
class DurationSpec:
    """Host-side knowledge for a duration artifact: the window from the
    program's input shapes, the audio constants and vocabulary size from
    the header."""

    batch: int
    padded_len: int
    mel_dim: int
    hop_length: int = 256
    sample_rate: int = 24_000
    text_num_embeds: int | None = None


_DERIVED_DURATION_FIELDS = {"batch", "padded_len", "mel_dim"}


def save_duration(exported: Exported, path, *, predictor) -> None:
    """Write a duration artifact (the sampler's container, header `kind:
    "duration"`). The predictor is required: the header records its audio
    constants and vocabulary size, and an `embed_weights=False` export
    stores its weights."""
    if exported.meta.get("kind") != "duration":
        raise ValueError(f"save_duration takes a duration export, not a {exported.meta.get('kind')!r} one")
    meta = {**exported.meta, "hop_length": predictor.audio_cfg.hop_length,
            "sample_rate": predictor.audio_cfg.sample_rate, "text_num_embeds": predictor.cfg.text_num_embeds}
    blobs: list = []
    if _n_inputs(exported) > _N_DURATION_ARGS:
        meta["weights"], blobs = _weight_blobs(_weights(_DurationProgram(predictor)), exported,
                                               _N_DURATION_ARGS, "predictor")
    _write_container(path, meta, blobs, exported.program)


def load_duration(path, device=None) -> tuple[LoadedProgram, DurationSpec]:
    """Reload a duration artifact onto `device` (as `load_sampler`); returns
    (predictor, spec). Run it as `predictor.call(*prep_duration_inputs(spec,
    ...))` -> seconds f32[b] on the device."""
    meta, weights, program = _read_container(path)
    kind = meta.pop("kind", None)
    if kind != "duration":
        raise ValueError(f"{path} is not a duration artifact (sampling artifacts load via load_sampler)")
    predictor = _loaded(program, weights, meta, path, device, _N_DURATION_ARGS, None)
    b, length, d = _input_shapes(program)[-3]
    known = {f.name for f in dataclasses.fields(DurationSpec)} - _DERIVED_DURATION_FIELDS
    meta = {k: v for k, v in meta.items() if k in known}
    return predictor, DurationSpec(batch=b, padded_len=length, mel_dim=d, **meta)


def prep_duration_inputs(
    spec: DurationSpec,
    cond_mel,  # [b, n, mel] reference mel (prefix-truncated to fit), numpy or a tensor
    text_ids: np.ndarray,  # [b, nt] int ids padded with -1
    *,
    lens: np.ndarray | None = None,
) -> tuple:
    """Host-side prep for a loaded duration artifact: the mel window and
    the text zero- and -1-padded to `padded_len`, `lens` each item's frame
    count by default. A reference longer than the window must be truncated
    by the caller (predicting from a prefix is the predictor's training
    task); text longer than the window raises."""
    if not isinstance(cond_mel, torch.Tensor):
        cond_mel = np.asarray(cond_mel, np.float32)
    b, n, d = cond_mel.shape
    if (b, d) != (spec.batch, spec.mel_dim) or n > spec.padded_len:
        raise ValueError(f"cond {tuple(cond_mel.shape)} does not fit duration-artifact window "
                         f"[{spec.batch}, {spec.padded_len}, {spec.mel_dim}]")
    text_np = np.asarray(text_ids, np.int32)
    _check_text(spec, text_np, "predictor")
    text_lens = (text_np != -1).sum(axis=-1)
    if text_np.shape[1] > spec.padded_len and int(text_lens.max()) > spec.padded_len:
        raise ValueError(f"text length {int(text_lens.max())} exceeds the duration artifact's window "
                         f"({spec.padded_len}); pass an explicit duration or export a larger --padded-len")
    text = np.full((b, spec.padded_len), -1, np.int32)
    ncopy = min(text_np.shape[1], spec.padded_len)
    text[:, :ncopy] = text_np[:, :ncopy]
    lens_np = np.full((b,), n, np.int32) if lens is None else np.asarray(lens, np.int32)
    return _padded_cond(cond_mel, spec.padded_len), text, np.clip(lens_np, 1, spec.padded_len).astype(np.int32)


def main(argv=None) -> None:
    """Build a deployment artifact from a local snapshot directory:

        f5-tts-tpu-torch-export --model SNAPSHOT_DIR --out sampler.bin \\
            --batch 8 --padded-len 1024 --steps 8 --method rk4

    The snapshot is a `save_pretrained` directory. --w8a8 exports the W8A8
    int8-compute sampler, --mel-only leaves the vocoder out, --duration
    exports the snapshot's duration predictor instead of a sampler. The
    model loads onto --device (the card by default), and the artifact is
    exported for that device type."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help="local snapshot dir (save_pretrained)")
    ap.add_argument("--out", required=True, help="output artifact path")
    ap.add_argument("--duration", action="store_true",
                    help="export the snapshot's duration predictor (duration_v2) instead of a sampling artifact; "
                         "--padded-len is the reference-mel window in frames (default 1024)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--padded-len", type=int, default=None, help="duration bucket in frames (default: one bucket)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--method", default="rk4", choices=("euler", "midpoint", "rk4"))
    ap.add_argument("--cfg", type=float, default=2.0, dest="cfg_strength")
    ap.add_argument("--w8a8", action="store_true", help="export W8A8 int8 compute")
    ap.add_argument("--mel-only", action="store_true", help="exclude the vocoder")
    ap.add_argument("--no-flash", action="store_true",
                    help="refused: the port's artifacts are portable without it (see export.py)")
    ap.add_argument("--external-weights", action="store_true",
                    help="export the weights as a program argument stored beside the program in the same file")
    ap.add_argument("--device", default="cuda", help="device to load the model onto and export for")
    args = ap.parse_args(argv)
    if args.no_flash:
        raise ValueError(USE_FLASH_REFUSED)

    from f5_tts_tpu_torch.models.cfm import F5TTS

    model = F5TTS.from_pretrained(args.model, device=args.device)
    if args.duration:
        for flag, name in ((args.w8a8, "--w8a8"), (args.mel_only, "--mel-only")):
            if flag:
                ap.error(f"{name} does not apply to --duration exports")
        predictor = model.duration_predictor
        if predictor is None:
            ap.error(f"{args.model} has no duration_v2.safetensors; --duration needs a snapshot with a trained "
                     "predictor")
        exported = export_duration(predictor, batch=args.batch, padded_len=args.padded_len or 1024,
                                   embed_weights=not args.external_weights)
        save_duration(exported, args.out, predictor=predictor)
        print(f"wrote {args.out}: duration predictor, window {list(exported.input_shapes()[-3])}, device "
              f"{exported.meta['device']}" + (" (external weights)" if args.external_weights else ""))
        return
    if args.w8a8:
        model.dit_cfg = model.dit_cfg.replace(int8_compute=True)
    exported = export_sampler(model, batch=args.batch, padded_len=args.padded_len, steps=args.steps,
                              method=args.method, cfg_strength=args.cfg_strength, with_vocoder=not args.mel_only,
                              embed_weights=not args.external_weights)
    save_sampler(exported, args.out, model=model,
                 extra_meta={"method": args.method, "cfg_strength": args.cfg_strength})
    bucket = [args.batch, *exported.input_shapes()[-7][1:]]
    print(f"wrote {args.out}: bucket {bucket}, {args.steps} {args.method} steps, "
          f"device {exported.meta['device']}" + (" (external weights)" if args.external_weights else ""))


if __name__ == "__main__":
    main()
