"""Operations and bytes of E2 TTS's UNetT training, from shapes alone, as
benchmark/flops.py counts the DiT's: a product is 2 m k n operations,
attention 4 h d operations for each (query, key) pair forward, a kernel's
bytes its inputs read once and its outputs written once; the backward
counts twice the forward. Every padded frame counts, and the time token
makes n + 1 positions in the layers: the blocks, the skip merges, the
norms and attention run over n + 1 rows, the input embedding and the head
over n.
"""

from __future__ import annotations

import math

from benchmark.flops import PEAK_HBM_BYTES

RMS_TILE = 32  # rows over which the RMSNorm backward kernel writes one partial column sum of dg


def layer_row_flops(c: dict) -> float:
    """Operations per row (of n + 1) of one layer outside attention: q, k,
    v, the output projection and the feed-forward."""
    dim, inner, hidden = c["dim"], c["heads"] * c["dim_head"], c["dim"] * c["ff_mult"]
    return 2 * (3 * dim * inner + inner * dim + 2 * dim * hidden)


def skip_row_flops(c: dict) -> float:
    """Operations per row of one skip merge, Linear(2 dim -> dim)."""
    return 2 * 2 * c["dim"] * c["dim"]


def frame_flops(c: dict) -> float:
    """Operations per frame (of n) outside the layers: the input projection,
    the convolutional position embedding and the output head."""
    dim = c["dim"]
    conv = 2 * 2 * (dim // 16) * 31 * dim
    return 2 * (2 * c["mel_dim"] + c["text_dim"]) * dim + conv + 2 * dim * c["mel_dim"]


def sample_flops(c: dict) -> float:
    """Operations per sample of the time embedding's MLP."""
    return 2 * (256 * c["dim"] + c["dim"] * c["dim"])


def forward_flops(c: dict, batch: int, n: int) -> float:
    """One UNetT forward over a padded batch of n frames (n + 1 positions)."""
    rows = n + 1
    layers = c["depth"] * layer_row_flops(c) + c["depth"] // 2 * skip_row_flops(c)
    attention = 4 * c["heads"] * c["dim_head"] * c["depth"] * rows * rows
    return batch * (rows * layers + n * frame_flops(c) + attention + sample_flops(c))


def train_step_flops(config: dict, batch: int, n: int) -> float:
    """Forward, and a backward at twice the forward, over the padded batch."""
    return 3 * forward_flops(config["unett"], batch, n)


def rms_norm_calls(c: dict) -> int:
    """RMSNorm calls a forward: two a layer and the final norm."""
    return 2 * c["depth"] + 1


def rms_norm_bytes(rows: int, d: int, elem: int = 2) -> tuple[float, float]:
    """(forward, backward) bytes of one RMSNorm over `rows` rows of width d
    in `elem`-byte activations: forward x read, y written, g read and each
    row's float32 inverse norm written; backward x, dy and the inverse norms
    read, g read, dx written and the float32 partial sums of dg, one row of
    d a tile of RMS_TILE rows, written."""
    forward = 2 * elem * rows * d + 4 * d + 4 * rows
    backward = 3 * elem * rows * d + 4 * rows + 4 * d + 4 * d * math.ceil(rows / RMS_TILE)
    return forward, backward


def rms_norm_least_seconds(config: dict, batch: int, n: int) -> float:
    """The least time of one training step's RMSNorm kernels, forward and
    backward, by their bytes (they do a few operations a byte)."""
    c = config["unett"]
    elem = 2 if c["compute_dtype"] == "bfloat16" else 4
    forward, backward = rms_norm_bytes(batch * (n + 1), c["dim"], elem)
    return rms_norm_calls(c) * (forward + backward) / PEAK_HBM_BYTES

