"""Snapshot conversion and loading (the port of the JAX package's
`models/convert.py`): the float DiT, the MLX-quantized DiT, the duration
model and the vocoder.

The port's modules carry the published checkpoint's parameter names, so
loading is a renaming of prefixes plus layout rules:
  - key normalization: the "ema_model." and "transformer." prefixes are
    stripped and MLX's ".layers." Sequential segments removed, so torch-EMA
    and MLX naming both map onto the module names;
  - conv weights are [out, in/g, k] in torch layout and [out, k, in/g] in MLX
    layout; the layout is inferred per tensor from the kernel size. The float
    DiT file is in torch layout; the quantized DiT, duration and Vocos files
    are in MLX layout;
  - an MLX-quantized linear is a `.scales` sibling beside packed uint32
    `.weight` codes and MLX `.biases` (the group minimum); it becomes a
    `QuantizedLinear`'s int8 codes, scales and offset-folded biases.
Loading fails on missing and on unconsumed keys.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from f5_tts_tpu_torch.config import (
    F5TTS_V1_BASE,
    AudioConfig,
    CFMConfig,
    DiTConfig,
    DurationConfig,
    VocosConfig,
)
from f5_tts_tpu_torch.utils.safetensors import load_file
from f5_tts_tpu_torch.utils.tokenizer import load_vocab


def _normalize(raw: dict[str, np.ndarray], strip_prefixes: tuple[str, ...]) -> dict[str, np.ndarray]:
    out = {}
    for k, v in raw.items():
        for p in strip_prefixes:
            k = k.removeprefix(p)
        out[k.replace(".layers.", ".")] = v
    return out


def _consume(module: nn.Module, flat: dict[str, np.ndarray], ignore_prefix: str | None = None) -> dict:
    """Take every persistent tensor of `module` from `flat` by name, in the
    module's layout; raise on missing or leftover keys."""
    flat = dict(flat)
    state = {}
    for name, ref in module.state_dict().items():
        if name not in flat:
            near = [k for k in flat if k.split(".")[-1] == name.split(".")[-1]][:5]
            raise KeyError(f"checkpoint is missing '{name}'; available near-misses: {near}")
        w = np.asarray(flat.pop(name))
        if ref.ndim == 3:  # conv weight [out, in/g, k]
            k = ref.shape[-1]
            if w.shape[-1] == k:  # torch layout
                pass
            elif w.shape[1] == k:  # MLX layout [out, k, in/g]
                w = np.swapaxes(w, 1, 2)
            else:
                raise ValueError(f"cannot infer conv layout for '{name}' with shape {w.shape}")
        elif name.endswith((".gamma", ".beta")) and w.size == ref.numel():  # [dim] vs [1, 1, dim]
            w = w.reshape(tuple(ref.shape))
        if tuple(w.shape) != tuple(ref.shape):
            raise ValueError(f"'{name}' has shape {w.shape}, expected {tuple(ref.shape)}")
        state[name] = torch.from_numpy(np.ascontiguousarray(w))
    leftovers = sorted(k for k in flat if ignore_prefix is None or not k.startswith(ignore_prefix))
    if leftovers:
        raise ValueError(f"unconsumed checkpoint keys: {leftovers[:10]}")
    return state


def _unpack_quantized(flat: dict[str, np.ndarray], bits: int | None) -> dict[str, np.ndarray]:
    """Turn every MLX-quantized linear of a normalized flat dict (a `.scales`
    key beside packed `.weight` codes and MLX `.biases`) into the names and
    layout of a `QuantizedLinear`: int8 `.q` [out, in] centred by
    -2^(bits-1), `.scales`, and `.biases` with the offset folded in."""
    from f5_tts_tpu_torch.models.quant import unpack_mlx_uint32

    out = dict(flat)
    for key in [k[: -len(".scales")] for k in flat if k.endswith(".scales")]:
        if bits is None:
            raise ValueError(f"'{key}' is quantized; pass quantization_bits to load it")
        if f"{key}.weight" not in out or f"{key}.biases" not in out:
            raise KeyError(f"quantized linear '{key}' needs .weight, .scales and .biases")
        offset = 1 << (bits - 1)
        codes = unpack_mlx_uint32(out.pop(f"{key}.weight"), bits)  # [out, in] uint8
        scales = out[f"{key}.scales"]
        out[f"{key}.q"] = (codes.astype(np.int16) - offset).astype(np.int8)
        out[f"{key}.biases"] = out[f"{key}.biases"] + offset * scales
    return out


def convert_dit_state(
    raw: dict[str, np.ndarray], cfg: DiTConfig, quant_bits: int | None = None
) -> dict[str, torch.Tensor]:
    """F5-TTS DiT checkpoint (torch-EMA or MLX naming, float or MLX-quantized
    with `quant_bits`) -> `DiT` state dict; for a quantized checkpoint, the
    state dict of a DiT after `quantize_module_`."""
    from f5_tts_tpu_torch.models.dit import DiT
    from f5_tts_tpu_torch.models.quant import quantize_module_

    filtered = {
        k: v
        for k, v in raw.items()
        if k.removeprefix("ema_model.")
        and not k.removeprefix("ema_model.").startswith("mel_spec.")
        and k.removeprefix("ema_model.") not in ("initted", "step")
    }
    with torch.device("meta"):
        shapes = DiT(cfg)
    if quant_bits is not None:
        quantize_module_(shapes, None)
    flat = _unpack_quantized(_normalize(filtered, ("ema_model.", "transformer.")), quant_bits)
    return _consume(shapes, flat, "rotary_embed.")


def convert_duration_state(raw: dict[str, np.ndarray], cfg: DurationConfig) -> dict[str, torch.Tensor]:
    """duration_v2.safetensors (MLX naming) -> `DurationPredictor` state dict."""
    from f5_tts_tpu_torch.models.duration import DurationPredictor

    with torch.device("meta"):
        shapes = DurationPredictor(cfg)
    return _consume(shapes, _normalize(raw, ()), "transformer.rotary_embed.")


def convert_vocos_state(raw: dict[str, np.ndarray], cfg: VocosConfig) -> dict[str, torch.Tensor]:
    """Vocos mel-24khz checkpoint (torch or MLX naming) -> `Vocos` state dict."""
    from f5_tts_tpu_torch.models.vocos import Vocos

    filtered = {
        k: v
        for k, v in raw.items()
        if not k.startswith("feature_extractor.") and "istft.window" not in k
    }
    with torch.device("meta"):
        shapes = Vocos(cfg)
    return _consume(shapes, _normalize(filtered, ()))


# ----------------------------------------------------------------- export


def rotary_inv_freq(dim_head: int) -> np.ndarray:
    """The reference model's RotaryEmbedding.inv_freq tensor, which its strict
    loader requires in the file."""
    return (1.0 / (10000.0 ** (np.arange(0, dim_head, 2, dtype=np.float32) / dim_head))).astype(np.float32)


def _to_numpy(module: nn.Module) -> dict[str, np.ndarray]:
    from f5_tts_tpu_torch.models.quant import QuantizedLinear

    if any(isinstance(m, QuantizedLinear) for m in module.modules()):
        raise ValueError("exporting needs float weights; this model holds quantized linears")
    return state_numpy(module.state_dict())


def state_numpy(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A float state dict as float32 numpy arrays on the host."""
    return {k: v.detach().float().cpu().numpy() for k, v in state.items()}


# (module name fragment, MLX fragment): MLX names the members of a
# Sequential "<name>.layers.<i>"
_MLX_RENAMES = (
    (".to_out.", ".to_out.layers."),
    (".text_blocks.", ".text_blocks.layers."),
    (".ff.ff.0.0.", ".ff.ff.layers.0.layers.0."),
    (".ff.ff.2.", ".ff.ff.layers.2."),
    (".time_mlp.", ".time_mlp.layers."),
    (".conv1d.", ".conv1d.layers."),
    (".to_pred.", ".to_pred.layers."),
)


def export_mlx_state(module: nn.Module) -> dict[str, np.ndarray]:
    """A module's float state in MLX naming and MLX conv layout, the inverse
    of the loader's normalization. For the DiT it is what the JAX package's
    `export_dit_state` writes, which `to_mlx_model_naming` and
    `quantize_flat_mlx` turn into a published quantized file."""
    return mlx_names(_to_numpy(module))


def mlx_names(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A float state dict (module names, torch layouts, as numpy arrays) in
    MLX naming and MLX conv layout; `export_mlx_state` of a module's state,
    and of a trainer's EMA copy."""
    out = {}
    for k, v in flat.items():
        key = f".{k}"
        for frag, mlx in _MLX_RENAMES:
            key = key.replace(frag, mlx)
        out[key[1:]] = np.ascontiguousarray(np.swapaxes(v, 1, 2)) if v.ndim == 3 and k.endswith(".weight") else v
    return out


def export_dit_state(dit: nn.Module) -> dict[str, np.ndarray]:
    """`DiT` -> the published model_v1.safetensors convention: torch-EMA
    naming, torch conv layouts, and the rotary inv_freq tensor."""
    out = {f"ema_model.transformer.{k}": v for k, v in _to_numpy(dit).items()}
    out["ema_model.transformer.rotary_embed.inv_freq"] = rotary_inv_freq(dit.cfg.dim_head)
    return out


def to_mlx_model_naming(flat: dict[str, np.ndarray], dim_head: int) -> dict[str, np.ndarray]:
    """MLX-named DiT export -> full-model MLX naming ("transformer." prefix
    and the rotary inv_freq), the convention of the published quantized
    files."""
    out = {f"transformer.{k}": np.asarray(v) for k, v in flat.items()}
    out["transformer.rotary_embed.inv_freq"] = rotary_inv_freq(dim_head)
    return out


def export_duration_state(predictor: nn.Module) -> dict[str, np.ndarray]:
    """`DurationPredictor` -> the published duration_v2.safetensors
    convention: MLX naming and conv layouts, and the rotary inv_freq tensor
    the reference's strict loader requires."""
    out = export_mlx_state(predictor)
    out["transformer.rotary_embed.inv_freq"] = rotary_inv_freq(predictor.cfg.dim_head)
    return out


def export_vocos_state(vocos: nn.Module) -> dict[str, np.ndarray]:
    """`Vocos` -> the published vocos naming with MLX conv layouts."""
    return export_mlx_state(vocos)


# ------------------------------------------------------ from the JAX package


def params_from_jax(np_tree: dict, cfg: DiTConfig | VocosConfig | DurationConfig) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree, as numpy arrays (DiT and duration
    blocks stacked [depth, ...]), -> the port's `DiT`, `Vocos` or
    `DurationPredictor` state dict. JAX keeps a linear kernel as [in, out],
    a quantized linear as {q [in, out], scales and biases [in / 64, out]},
    a W8A8 one as {w8 [in, out], w8_scale [out]}, and a conv kernel as
    [k, in/g, out]."""
    out: dict[str, np.ndarray] = {}

    def lin(key, p):
        if "q" in p:
            for name in ("q", "scales", "biases"):
                out[f"{key}.{name}"] = np.asarray(p[name]).T
        elif "w8" in p:
            out[f"{key}.w8"] = np.asarray(p["w8"]).T
            out[f"{key}.w8_scale"] = np.asarray(p["w8_scale"])
        else:
            out[f"{key}.weight"] = np.asarray(p["kernel"]).T
        if "bias" in p:
            out[f"{key}.bias"] = np.asarray(p["bias"])

    def conv(key, p):
        out[f"{key}.weight"] = np.transpose(np.asarray(p["kernel"]), (2, 1, 0))
        out[f"{key}.bias"] = np.asarray(p["bias"])

    def norm(key, p):
        out[f"{key}.weight"] = np.asarray(p["scale"])
        out[f"{key}.bias"] = np.asarray(p["bias"])

    def text_embed(key, te):
        out[f"{key}.text_embed.weight"] = np.asarray(te["embed"]["embedding"])
        for i, p in enumerate(te.get("blocks", [])):
            bkey = f"{key}.text_blocks.{i}"
            conv(f"{bkey}.dwconv", p["dwconv"])
            norm(f"{bkey}.norm", p["norm"])
            lin(f"{bkey}.pwconv1", p["pwconv1"])
            out[f"{bkey}.grn.gamma"] = np.asarray(p["grn"]["gamma"])
            out[f"{bkey}.grn.beta"] = np.asarray(p["grn"]["beta"])
            lin(f"{bkey}.pwconv2", p["pwconv2"])

    def input_embed(key, ie):
        lin(f"{key}.proj", ie["proj"])
        conv(f"{key}.conv_pos_embed.conv1d.0", ie["conv_pos_embed"]["conv1"])
        conv(f"{key}.conv_pos_embed.conv1d.2", ie["conv_pos_embed"]["conv2"])

    def attn_ff(key, blocks, i):
        at = lambda p: {k: np.asarray(v)[i] for k, v in p.items()}  # noqa: E731
        for name in ("to_q", "to_k", "to_v"):
            lin(f"{key}.attn.{name}", at(blocks["attn"][name]))
        lin(f"{key}.attn.to_out.0", at(blocks["attn"]["to_out"]))
        lin(f"{key}.ff.ff.0.0", at(blocks["ff"]["w1"]))
        lin(f"{key}.ff.ff.2", at(blocks["ff"]["w2"]))

    if isinstance(cfg, DurationConfig):
        text_embed("transformer.text_embed", np_tree["text_embed"])
        input_embed("transformer.input_embed", np_tree["input_embed"])
        for i in range(cfg.depth):
            attn_ff(f"transformer.transformer_blocks.{i}", np_tree["blocks"], i)
        out["transformer.norm_out.weight"] = np.asarray(np_tree["norm_out"]["scale"])
        lin("to_pred.0", np_tree["to_pred"])
    elif isinstance(cfg, VocosConfig):
        conv("backbone.embed", np_tree["embed"])
        norm("backbone.norm", np_tree["norm"])
        for i, p in enumerate(np_tree["convnext"]):
            key = f"backbone.convnext.{i}"
            conv(f"{key}.dwconv", p["dwconv"])
            norm(f"{key}.norm", p["norm"])
            lin(f"{key}.pwconv1", p["pwconv1"])
            lin(f"{key}.pwconv2", p["pwconv2"])
            out[f"{key}.gamma"] = np.asarray(p["gamma"])
        norm("backbone.final_layer_norm", np_tree["final_layer_norm"])
        lin("head.out", np_tree["head"])
    else:
        lin("time_embed.time_mlp.0", np_tree["time_embed"]["mlp1"])
        lin("time_embed.time_mlp.2", np_tree["time_embed"]["mlp2"])
        text_embed("text_embed", np_tree["text_embed"])
        input_embed("input_embed", np_tree["input_embed"])
        blocks = np_tree["blocks"]
        for i in range(cfg.depth):
            key = f"transformer_blocks.{i}"
            lin(f"{key}.attn_norm.linear", {k: np.asarray(v)[i] for k, v in blocks["attn_norm"]["linear"].items()})
            attn_ff(key, blocks, i)
        lin("norm_out.linear", np_tree["norm_out"]["linear"])
        lin("proj_out", np_tree["proj_out"])
    # int8 codes keep their type; every other leaf is float32
    return {k: torch.tensor(v, dtype=torch.int8 if v.dtype == np.int8 else torch.float32) for k, v in out.items()}


# ----------------------------------------------------------------- loading


def load_f5tts_pretrained(
    local_dir: str | Path, device: torch.device | str = "cuda", quantization_bits: int | None = None,
    expected_sha256: dict[str, str] | None = None,
):
    """Build a ready-to-sample F5TTS from a snapshot directory written by
    either package's `save_pretrained` (or the published artifacts with a
    `vocos/` subdirectory): its files first verified against
    `expected_sha256` (utils/hub.py `verify_artifacts`), then vocab,
    `config.json` when present, the DiT weights (model_v1.safetensors, or
    model_v1_{b}b.safetensors with `quantization_bits=b`), the duration
    predictor when the snapshot has duration_v2.safetensors, and the vocoder
    (`load_vocos_pretrained` on `vocos/`). A config with `int8_compute`
    samples W8A8; with `quantization_bits` too, sampling raises ValueError,
    as the JAX package does."""
    from f5_tts_tpu_torch.models.cfm import F5TTS
    from f5_tts_tpu_torch.models.dit import DiT
    from f5_tts_tpu_torch.models.duration import DurationPredictor
    from f5_tts_tpu_torch.models.quant import quantize_module_
    from f5_tts_tpu_torch.utils.hub import verify_artifacts

    path = Path(local_dir)
    if not path.is_dir():
        raise ValueError(f"the PyTorch package loads local snapshot directories only (downloading from the hub is "
                         f"not ported): {str(local_dir)!r} is not a directory")
    if expected_sha256:
        verify_artifacts(path, expected_sha256)
    vocab_path = path / "vocab.txt"
    vocab = load_vocab(vocab_path) if vocab_path.exists() else None

    cfg_path = path / "config.json"
    cfg_blob: dict = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
    audio_cfg = AudioConfig(**cfg_blob.get("audio", {}))

    if "dit" in cfg_blob:
        dit_cfg = DiTConfig(**cfg_blob["dit"])
    elif vocab is not None:
        dit_cfg = F5TTS_V1_BASE.replace(text_num_embeds=len(vocab) - 1)
    else:
        dit_cfg = F5TTS_V1_BASE
    with torch.device(device):
        dit = DiT(dit_cfg)
    model_file = "model_v1.safetensors" if quantization_bits is None else f"model_v1_{quantization_bits}b.safetensors"
    if quantization_bits is not None:
        quantize_module_(dit, None)
    dit.load_state_dict(convert_dit_state(load_file(path / model_file), dit_cfg, quantization_bits))

    duration_predictor = None
    if (path / "duration_v2.safetensors").exists():
        if "duration" in cfg_blob:
            dur_cfg = DurationConfig(**cfg_blob["duration"])
        elif vocab is not None:
            dur_cfg = DurationConfig(text_num_embeds=len(vocab) - 1)
        else:
            dur_cfg = DurationConfig()
        with torch.device(device):
            duration_predictor = DurationPredictor(dur_cfg, audio_cfg)
        duration_predictor.load_state_dict(
            convert_duration_state(load_file(path / "duration_v2.safetensors"), dur_cfg))

    vocos_dir = path / "vocos"
    if not vocos_dir.exists():
        raise FileNotFoundError(f"{path} has no vocos/ subdirectory with the vocoder weights")
    vocos_cfg = VocosConfig(**cfg_blob["vocos"]) if "vocos" in cfg_blob else None
    vocos = load_vocos_pretrained(vocos_dir, vocos_cfg, device)

    cfm_blob = dict(cfg_blob.get("cfm", {}))
    if "frac_lengths_mask" in cfm_blob:  # JSON stores the tuple as a list
        cfm_blob["frac_lengths_mask"] = tuple(cfm_blob["frac_lengths_mask"])
    return F5TTS(
        dit, dit_cfg, cfm_cfg=CFMConfig(**cfm_blob), audio_cfg=audio_cfg,
        vocab_char_map=vocab, vocoder=vocos, duration_predictor=duration_predictor,
    )


# the vocoder's checkpoint names, in the order the JAX loader tries them
VOCOS_FILES = ("model.safetensors", "pytorch_model.bin", "weights.safetensors")


def load_vocos_pretrained(local_dir: str | Path, cfg: VocosConfig | None = None,
                          device: torch.device | str = "cuda"):
    """The Vocos vocoder from a local directory: the first of `VOCOS_FILES`
    it holds (safetensors by the port's reader, `pytorch_model.bin` by
    `torch.load(weights_only=True)`), in torch or MLX naming and layout.
    Raises FileNotFoundError when it holds none."""
    from f5_tts_tpu_torch.models.vocos import Vocos

    local = Path(local_dir)
    cfg = cfg or VocosConfig()
    for name in VOCOS_FILES:
        ckpt = local / name
        if not ckpt.exists():
            continue
        if ckpt.suffix == ".safetensors":
            flat = load_file(ckpt)
        else:
            flat = {k: v.numpy() for k, v in torch.load(ckpt, map_location="cpu", weights_only=True).items()}
        with torch.device(device):
            vocos = Vocos(cfg)
        vocos.load_state_dict(convert_vocos_state(flat, cfg))
        return vocos
    raise FileNotFoundError(f"no vocos checkpoint ({', '.join(VOCOS_FILES)}) found under {local}")
