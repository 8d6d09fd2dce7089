"""Operations and bytes of F5-TTS's work, from shapes alone, and the
published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).

A count is that of the work as the model defines it, whatever implements
it: a product is 2 m k n operations; attention is 4 h d operations for each
(query, key) pair forward and 10 backward; a kernel's bytes are its inputs
read once and its outputs written once. Training counts every padded
frame, since its forward passes no mask and padded frames are keys that
valid ones attend to.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of its two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def dit_token_flops(c: dict) -> float:
    """Operations per frame of one DiT forward outside attention: the input
    projection, the convolutional position embedding, every block's
    projections and feed-forward, the output head."""
    dim, inner, hidden = c["dim"], c["heads"] * c["dim_head"], c["dim"] * c["ff_mult"]
    per_block = 2 * (3 * dim * inner + inner * dim + 2 * dim * hidden)
    conv = 2 * 2 * (dim // 16) * 31 * dim
    return 2 * (2 * c["mel_dim"] + c["text_dim"]) * dim + conv + c["depth"] * per_block + 2 * dim * c["mel_dim"]


def text_token_flops(c: dict) -> float:
    """Operations per frame of the text branch (ConvNeXt V2 blocks)."""
    td, ti = c["text_dim"], c["text_dim"] * c["conv_mult"]
    return c["conv_layers"] * (2 * 2 * td * ti + 2 * 7 * td)


def attention_pairs(c: dict) -> float:
    """Operations per (query, key) pair of one forward, over every layer."""
    return 4 * c["heads"] * c["dim_head"] * c["depth"]


def train_step_flops(config: dict, batch: int, n: int) -> float:
    """Forward, and a backward at twice the forward, over the padded batch."""
    c = config["dit"]
    forward = batch * n * (dit_token_flops(c) + text_token_flops(c)) + batch * n * n * attention_pairs(c)
    return 3 * forward


def k1_call(c: dict, valid: list[int], n: int, lse: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one attention forward over rows whose valid
    frames are `valid` (queries and keys alike), of a sequence of n."""
    h, d = c["heads"], c["dim_head"]
    flops = 4 * h * d * sum(float(v) * v for v in valid)
    nbytes = 2 * 4 * h * d * sum(valid) + (4 * h * n * len(valid) if lse else 0)
    return flops, nbytes


def k2_call(c: dict, batch: int, n: int) -> tuple[float, float]:
    """(operations, bytes) of one attention backward without a mask: q, k,
    v, out, its gradient and the log-sum-exp in, dq, dk, dv out."""
    h, d = c["heads"], c["dim_head"]
    return 10.0 * batch * h * n * n * d, 2 * 8 * batch * h * n * d + 4 * batch * h * n
