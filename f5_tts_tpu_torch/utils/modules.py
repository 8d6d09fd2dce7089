"""Neural-network primitives on [b, n, c] tensors (the port of the JAX
package's `utils/modules.py`).

Weights are in PyTorch's layouts: a linear weight is [out, in], a conv1d
weight [out, in/groups, k]. As in the JAX package, a weight is cast to the
activation's dtype at use, so bf16 activations run bf16 matmuls whatever
dtype the weights are stored in.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator) -> None:
    """Random init with the JAX package's distributions, drawn from
    `generator`: linear and conv weights and biases U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), embeddings N(0, 1). Norm, GRN and layer-scale
    parameters keep the constants their constructors set."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(generator=generator)


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in `dtype`: t itself when it is already, so that a program traced
    with torch.export records no cast for it."""
    return t if t.dtype == dtype else t.to(dtype)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    return F.linear(x, cast(weight, x.dtype), None if bias is None else cast(bias, x.dtype))


def apply_linear(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a float `nn.Linear` (weight cast to x's dtype), a weight-only
    quantized linear (models/quant.py `QuantizedLinear`, whose forward runs
    the dequantizing matmul) or a W8A8 one (`W8A8Linear`, whose forward
    quantizes x per token and runs the int8 product)."""
    if isinstance(layer, nn.Linear):
        return linear(x, layer.weight, layer.bias)
    return layer(x)


def embedding(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Row gather with out-of-range ids clamped into the table, as the JAX
    package's `mode="clip"` gather does (torch would raise instead)."""
    if dtype is not None:
        table = table.to(dtype)
    return F.embedding(ids.clamp(0, table.shape[0] - 1), table)


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics; affine iff
    weight is given (then bias must be too)."""
    xf = cast(x, torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = cast((xf - mean) * torch.rsqrt(var + eps), x.dtype)
    if weight is not None:
        y = y * cast(weight, x.dtype) + cast(bias, x.dtype)
    return y


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis with float32 statistics, then the scale."""
    xf = cast(x, torch.float32)
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return cast(y, x.dtype) * cast(weight, x.dtype)


def conv1d(
    x: torch.Tensor,  # [b, n, c]
    weight: torch.Tensor,  # [out, in/groups, k]
    bias: torch.Tensor | None = None,
    groups: int = 1,
    padding: int | None = None,
) -> torch.Tensor:
    """1D convolution on [b, n, c] inputs. `padding=None` is "SAME" for the
    odd kernel sizes the model uses."""
    if padding is None:
        padding = (weight.shape[-1] - 1) // 2
    y = F.conv1d(
        x.transpose(1, 2),
        cast(weight, x.dtype),
        None if bias is None else cast(bias, x.dtype),
        padding=padding,
        groups=groups,
    )
    return y.transpose(1, 2)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")
