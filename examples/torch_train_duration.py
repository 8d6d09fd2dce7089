"""Duration-predictor training from a local LibriTTS-R directory, on the
PyTorch port.

The port's counterpart of `examples/train_duration.py`: the 512-dim
8-layer predictor (`DurationConfig`) over a byte-level vocab, learning a
clip's duration in seconds from a random prefix of its mel (L1), fed by the
same pipeline as the CFM example with the mel computed on the host.
Nothing is downloaded: `--data-dir` is a directory already in LibriTTS-R
layout (`<speaker>/<chapter>/<id>.wav` beside `<id>.normalized.txt`).

    python examples/torch_train_duration.py --data-dir LibriTTS_R/dev-clean

`--mesh-data`, `--mesh-model` and `--fsdp` as in
examples/torch_train_libritts_small.py.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Train the duration predictor from a LibriTTS-R directory.")
    ap.add_argument("--data-dir", required=True, help="local directory in LibriTTS-R layout")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--depth", type=int, default=None, help="override the predictor's 8 layers")
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel rows over the devices of --device's type (one card a slot)")
    ap.add_argument("--mesh-model", type=int, default=1, help="tensor-parallel slots a data row")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the weight matrices, their AdamW moments and EMA over the data rows of every process")
    ap.add_argument("--total-steps", type=int, default=100_000)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import torch

    from f5_tts_tpu_torch import DurationConfig, DurationPredictor
    from f5_tts_tpu_torch.data import load_dir, make_training_pipeline
    from f5_tts_tpu_torch.generate import cli_mesh
    from f5_tts_tpu_torch.parallel import distributed

    distributed.initialize()  # a no-op unless WORLD_SIZE names several processes
    from f5_tts_tpu_torch.training import DurationTrainer

    vocab = {chr(i): i for i in range(256)}
    cfg = DurationConfig(dim=512, depth=8, heads=8, text_dim=512, ff_mult=2, conv_layers=2,
                         text_num_embeds=len(vocab))
    if args.depth is not None:
        cfg = cfg.replace(depth=args.depth)
    model = DurationPredictor.init(torch.Generator(device=args.device).manual_seed(0), cfg,
                                   device=args.device)
    print(f"Using {sum(p.numel() for p in model.parameters()):,} trainable parameters.")

    pipeline = make_training_pipeline(load_dir(args.data_dir, max_duration=30), batch_size=16, epochs=100,
                                      shuffle_buffer=500, seed=0,
                                      shard_by_process=distributed.process_count() > 1)

    trainer = DurationTrainer(model, num_warmup_steps=1000, max_grad_norm=1.0, results_dir=args.results_dir,
                              mesh=cli_mesh(args.mesh_data, args.mesh_model, args.device), fsdp=args.fsdp)
    trainer.train(pipeline, learning_rate=1e-4, total_steps=args.total_steps, save_every=10_000)


if __name__ == "__main__":
    main()
