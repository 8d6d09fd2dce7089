"""Snapshot conversion and loading, float weights only (the port of the JAX
package's `models/convert.py`).

The port's modules carry the published checkpoint's parameter names, so
loading is a renaming of prefixes plus two layout rules:
  - key normalization: the "ema_model." and "transformer." prefixes are
    stripped and MLX's ".layers." Sequential segments removed, so torch-EMA
    and MLX naming both map onto the module names;
  - conv weights are [out, in/g, k] in torch layout and [out, k, in/g] in MLX
    layout; the layout is inferred per tensor from the kernel size. The DiT
    file is in torch layout, the Vocos file in MLX layout.
Loading fails on missing and on unconsumed keys.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from f5_tts_tpu_torch.config import F5TTS_V1_BASE, AudioConfig, CFMConfig, DiTConfig, VocosConfig
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


def convert_dit_state(raw: dict[str, np.ndarray], cfg: DiTConfig) -> dict[str, torch.Tensor]:
    """Float F5-TTS DiT checkpoint (torch-EMA or MLX naming) -> `DiT` state dict."""
    from f5_tts_tpu_torch.models.dit import DiT

    filtered = {
        k: v
        for k, v in raw.items()
        if k.removeprefix("ema_model.")
        and not k.removeprefix("ema_model.").startswith("mel_spec.")
        and k.removeprefix("ema_model.") not in ("initted", "step")
    }
    with torch.device("meta"):
        shapes = DiT(cfg)
    return _consume(shapes, _normalize(filtered, ("ema_model.", "transformer.")), "rotary_embed.")


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
    return {k: v.detach().float().cpu().numpy() for k, v in module.state_dict().items()}


def export_dit_state(dit: nn.Module) -> dict[str, np.ndarray]:
    """`DiT` -> the published model_v1.safetensors convention: torch-EMA
    naming, torch conv layouts, and the rotary inv_freq tensor."""
    out = {f"ema_model.transformer.{k}": v for k, v in _to_numpy(dit).items()}
    out["ema_model.transformer.rotary_embed.inv_freq"] = rotary_inv_freq(dit.cfg.dim_head)
    return out


def export_vocos_state(vocos: nn.Module) -> dict[str, np.ndarray]:
    """`Vocos` -> the published vocos naming with MLX conv layouts."""
    return {k: np.swapaxes(v, 1, 2) if v.ndim == 3 else v for k, v in _to_numpy(vocos).items()}


# ------------------------------------------------------ from the JAX package


def params_from_jax(np_tree: dict, cfg: DiTConfig | VocosConfig) -> dict[str, torch.Tensor]:
    """The JAX package's parameter tree, as numpy arrays (DiT blocks stacked
    [depth, ...]), -> the port's `DiT` or `Vocos` state dict. JAX keeps a
    linear kernel as [in, out] and a conv kernel as [k, in/g, out]."""
    out: dict[str, np.ndarray] = {}

    def lin(key, p):
        out[f"{key}.weight"] = np.asarray(p["kernel"]).T
        if "bias" in p:
            out[f"{key}.bias"] = np.asarray(p["bias"])

    def conv(key, p):
        out[f"{key}.weight"] = np.transpose(np.asarray(p["kernel"]), (2, 1, 0))
        out[f"{key}.bias"] = np.asarray(p["bias"])

    def norm(key, p):
        out[f"{key}.weight"] = np.asarray(p["scale"])
        out[f"{key}.bias"] = np.asarray(p["bias"])

    if isinstance(cfg, VocosConfig):
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
        te = np_tree["text_embed"]
        out["text_embed.text_embed.weight"] = np.asarray(te["embed"]["embedding"])
        for i, p in enumerate(te.get("blocks", [])):
            key = f"text_embed.text_blocks.{i}"
            conv(f"{key}.dwconv", p["dwconv"])
            norm(f"{key}.norm", p["norm"])
            lin(f"{key}.pwconv1", p["pwconv1"])
            out[f"{key}.grn.gamma"] = np.asarray(p["grn"]["gamma"])
            out[f"{key}.grn.beta"] = np.asarray(p["grn"]["beta"])
            lin(f"{key}.pwconv2", p["pwconv2"])
        ie = np_tree["input_embed"]
        lin("input_embed.proj", ie["proj"])
        conv("input_embed.conv_pos_embed.conv1d.0", ie["conv_pos_embed"]["conv1"])
        conv("input_embed.conv_pos_embed.conv1d.2", ie["conv_pos_embed"]["conv2"])
        blocks = np_tree["blocks"]
        for i in range(cfg.depth):
            key = f"transformer_blocks.{i}"
            at = lambda p: {k: np.asarray(v)[i] for k, v in p.items()}  # noqa: E731
            lin(f"{key}.attn_norm.linear", at(blocks["attn_norm"]["linear"]))
            for name in ("to_q", "to_k", "to_v"):
                lin(f"{key}.attn.{name}", at(blocks["attn"][name]))
            lin(f"{key}.attn.to_out.0", at(blocks["attn"]["to_out"]))
            lin(f"{key}.ff.ff.0.0", at(blocks["ff"]["w1"]))
            lin(f"{key}.ff.ff.2", at(blocks["ff"]["w2"]))
        lin("norm_out.linear", np_tree["norm_out"]["linear"])
        lin("proj_out", np_tree["proj_out"])
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}


# ----------------------------------------------------------------- loading


def load_f5tts_pretrained(local_dir: str | Path, device: torch.device | str = "cpu"):
    """Build a ready-to-sample F5TTS from a snapshot directory written by
    either package's `save_pretrained` (or the published float artifacts with
    a `vocos/` subdirectory): vocab, `config.json` when present, the DiT
    weights and the vocoder."""
    from f5_tts_tpu_torch.models.cfm import F5TTS
    from f5_tts_tpu_torch.models.dit import DiT
    from f5_tts_tpu_torch.models.vocos import Vocos

    path = Path(local_dir)
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
    dit.load_state_dict(convert_dit_state(load_file(path / "model_v1.safetensors"), dit_cfg))

    vocos_dir = path / "vocos"
    if not vocos_dir.exists():
        raise FileNotFoundError(f"{path} has no vocos/ subdirectory with the vocoder weights")
    vocos_cfg = VocosConfig(**cfg_blob["vocos"]) if "vocos" in cfg_blob else VocosConfig()
    with torch.device(device):
        vocos = Vocos(vocos_cfg)
    vocos.load_state_dict(convert_vocos_state(load_file(vocos_dir / "model.safetensors"), vocos_cfg))

    cfm_blob = dict(cfg_blob.get("cfm", {}))
    if "frac_lengths_mask" in cfm_blob:  # JSON stores the tuple as a list
        cfm_blob["frac_lengths_mask"] = tuple(cfm_blob["frac_lengths_mask"])
    return F5TTS(
        dit, dit_cfg, cfm_cfg=CFMConfig(**cfm_blob), audio_cfg=audio_cfg,
        vocab_char_map=vocab, vocoder=vocos,
    )

