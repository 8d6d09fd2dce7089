"""The benchmark's plain reference of F5-TTS v1 training: the DiT forward
(and, by autograd, its backward) with its dropout, the CFM loss and AdamW
with an EMA.

It is written in plain PyTorch and NumPy, computes in float32 with TF32 off
(`exact`), and imports nothing of the program under test: it reads only the
raw weights and inputs that the benchmark makes from the seed, and works
out again whatever the program derives from them (the masks, the dropout
draws). `Precision` gives the lower-precision control that the
comparisons are shown to fail with.
"""

import torch


def exact() -> None:
    """float32 products without TF32, in matmuls and in cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
