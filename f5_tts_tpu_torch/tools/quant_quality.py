"""Output distortion of weight-only quantization (--q 8, --q 4): the
counterpart of the JAX package's `tools/quant_quality.py`.

    PYTHONPATH=. python -m f5_tts_tpu_torch.tools.quant_quality --device cpu

On the JAX tool's tiny config (dim 64, depth 2, 2 heads x 32, text_dim 32,
32-frame buckets, byte vocabulary, Vocos at dim 64), with random weights
from a seed: the whole pipeline (tokenize -> mel -> 32 Euler steps with CFG
2 and sway -1 -> mel) through the port's own snapshot machinery
(`save_pretrained` with `quantization_bits`, `from_pretrained`, `sample`)
against the float snapshot of the same weights. Prints one JSON line per
mode, as the JAX tool does:

    {"q": 8, "mel_rel_mae": ..., "mel_rel_rmse": ...}

rel-MAE = mean |mel_q - mel_f| / mean |mel_f|; rel-RMSE likewise with the
root mean square. It has no W8A8 mode: the JAX tool has none.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, VocosConfig
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.vocos import Vocos

TINY = DiTConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
                 text_num_embeds=256, text_dim=32, conv_layers=1)
VOCAB = {c: i for i, c in enumerate([""] + [chr(c) for c in range(32, 127)])}
TEXT = ["a pinned golden utterance."]


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description="mel distortion of the int8 and int4 weight-only snapshots")
    ap.add_argument("--device", default="cuda", help="the card by default, 'cpu' on request")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    src = F5TTS.init(gen, TINY, device=device, cfm_cfg=CFMConfig(duration_bucket=32), vocab_char_map=VOCAB,
                     vocoder=Vocos.init(gen, VocosConfig(dim=64, intermediate_dim=128, num_layers=2), device=device))
    sr = src.audio_cfg.sample_rate
    ref = (0.1 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)).astype(np.float32)

    def sample_mel(model) -> np.ndarray:
        model.vocoder = None  # return the mel, not the vocoded wave
        mel, _ = model.sample(ref[None, :], TEXT, duration=96, steps=32, method="euler", seed=12, cfg_strength=2.0,
                              sway_sampling_coef=-1.0, return_trajectory=False)
        return mel.float().cpu().numpy()

    with tempfile.TemporaryDirectory() as snap:
        src.save_pretrained(snap)
        mel_f = sample_mel(F5TTS.from_pretrained(snap, device=device))

    lines = []
    for q in (8, 4):
        with tempfile.TemporaryDirectory() as snap:
            src.save_pretrained(snap, quantization_bits=q)
            mel_q = sample_mel(F5TTS.from_pretrained(snap, device=device, quantization_bits=q))
        line = {
            "q": q,
            "mel_rel_mae": round(float(np.mean(np.abs(mel_q - mel_f))) / float(np.mean(np.abs(mel_f))), 6),
            "mel_rel_rmse": round(float(np.sqrt(np.mean((mel_q - mel_f) ** 2)))
                                  / float(np.sqrt(np.mean(mel_f ** 2))), 6),
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
