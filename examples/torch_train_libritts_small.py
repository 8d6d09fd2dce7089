"""Small-model CFM training from a local LibriTTS-R directory, on the
PyTorch port.

The port's counterpart of `examples/train_libritts_small.py`: a 768-dim
16-layer DiT (`F5TTS_SMALL`) over a byte-level vocab, batches of 4 clips of
at most 10 s (about 40 s of audio), mel frames padded to multiples of 256,
the mel computed on the card inside the step. Nothing is downloaded:
`--data-dir` is a directory already in LibriTTS-R layout
(`<speaker>/<chapter>/<id>.wav` beside `<id>.normalized.txt`), and
`--vocoder-dir` an optional local Vocos snapshot for the probe samples'
audio (without it the samples keep only their mel).

    python examples/torch_train_libritts_small.py --data-dir LibriTTS_R/dev-clean

Over several cards: `--mesh-data D --mesh-model M` trains on a D x M grid
(data-parallel rows, tensor-parallel slots; one card a slot), `--fsdp` also
shards the weight matrices and their optimizer state over the rows. Across
processes, set WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT (the script
calls `parallel.distributed.initialize()`, and each process then loads its
slice of every global batch); the data axis spans the processes, each
process's grid takes the cards it sees (CUDA_VISIBLE_DEVICES; with the
default 1 x 1, one slot a process), the gradients are summed across them,
and process 0 writes the weight files and the probe samples. `--fsdp`
shards over every process's rows (the global data axis): each process
stores 1/processes of each matrix, its moments and EMA, and gathers the
weights and reduce-scatters the gradients across the others.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REF_AUDIO = ROOT / "f5_tts_tpu_torch" / "assets" / "test_en_1_ref_short.wav"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Train the small F5-TTS DiT from a LibriTTS-R directory.")
    ap.add_argument("--data-dir", required=True, help="local directory in LibriTTS-R layout")
    ap.add_argument("--vocoder-dir", default=None, help="local Vocos snapshot for the probe samples' audio")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--depth", type=int, default=None, help="override F5TTS_SMALL's 16 layers")
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel rows over the devices of --device's type (one card a slot)")
    ap.add_argument("--mesh-model", type=int, default=1, help="tensor-parallel slots a data row")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the weight matrices, their AdamW moments and EMA over the data rows of every process")
    ap.add_argument("--total-steps", type=int, default=1_000_000)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import torch

    from f5_tts_tpu_torch import F5TTS, CFMConfig, Vocos
    from f5_tts_tpu_torch.config import F5TTS_SMALL
    from f5_tts_tpu_torch.data import load_dir, make_training_pipeline
    from f5_tts_tpu_torch.generate import cli_mesh
    from f5_tts_tpu_torch.parallel import distributed

    distributed.initialize()  # a no-op unless WORLD_SIZE names several processes
    from f5_tts_tpu_torch.training import F5TTSTrainer

    vocab = {chr(i): i for i in range(256)}
    vocoder = Vocos.from_pretrained(args.vocoder_dir, device=args.device) if args.vocoder_dir else None

    dit_cfg = F5TTS_SMALL.replace(text_num_embeds=len(vocab))
    if args.depth is not None:
        dit_cfg = dit_cfg.replace(depth=args.depth)
    f5tts = F5TTS.init(torch.Generator(device=args.device).manual_seed(0), dit_cfg, device=args.device,
                       cfm_cfg=CFMConfig(), vocab_char_map=vocab, vocoder=vocoder)
    print(f"Using {sum(p.numel() for p in f5tts.dit.parameters()):,} trainable parameters.")

    epochs, max_duration, max_batch_duration = 100, 10, 40
    batched_dataset = make_training_pipeline(
        load_dir(args.data_dir, max_duration=max_duration),
        batch_size=int(max_batch_duration / max_duration),
        epochs=epochs,
        shuffle_buffer=500,
        num_threads=6,
        pad_frame_multiple=256,
        seed=0,
        # raw-audio batches: the mel runs on the card inside the step
        on_device_mel=True,
        shard_by_process=distributed.process_count() > 1,
    )

    trainer = F5TTSTrainer(f5tts, num_warmup_steps=1000, max_grad_norm=1, results_dir=args.results_dir,
                           mesh=cli_mesh(args.mesh_data, args.mesh_model, args.device), fsdp=args.fsdp)
    trainer.train(
        batched_dataset,
        learning_rate=1e-4,
        total_steps=args.total_steps,
        save_every=10_000,
        sample_every=100,
        sample_reference_audio=str(REF_AUDIO),
        sample_reference_text="Some call me nature, others call me mother nature.",
        sample_generation_duration=3.5,
        sample_generation_text="The quick brown fox jumped over the lazy dog.",
        on_device_mel=True,
    )


if __name__ == "__main__":
    main()
