"""Weight-only int4/int8 quantization, MLX-compatible with group size 64,
and the W8A8 int8-compute linears (the port of the JAX package's
`models/quant.py`).

The published 4- and 8-bit snapshots (`model_v1_{4,8}b.safetensors`) hold,
for every linear whose input width is a multiple of 64, the codes packed
into uint32 words plus per-64-element affine `scales` and `biases` along the
input. This module
  - packs and unpacks those words and quantizes float kernels bit-for-bit
    as the JAX package does (host numpy, the JAX package's [in, out] kernel
    layout);
  - holds a quantized linear as `QuantizedLinear`, whose forward runs the
    dequantizing matmul (ops/qmatmul.py, kernel K3);
  - swaps a module's eligible `nn.Linear`s for it (`quantize_module_`).

A `QuantizedLinear` keeps PyTorch's [out, in] layout: codes q int8
[out, in], centred by -2^(bits-1) with the offset folded into `biases`
(= group min + 2^(bits-1) * scales), and scales and biases [out, in / 64].
Int4 codes take one byte each, as in the JAX package.

W8A8 (`DiTConfig.int8_compute`) is the other, orthogonal path: the DiT
blocks' attention projections and feed-forward linears (`W8A8_TARGETS`)
hold int8 weights with one float32 scale per output feature
(`w8a8_from_weight`) and quantize their activations per token at run time
(`W8A8Linear`, whose forward is ops/w8a8.py `w8a8_linear`).
`w8a8_blocks_` swaps them in place on the sampler's copy of the DiT and
refuses a weight-only quantized one.

A shard of a tensor-parallel group (parallel/mesh.py) holds slices of
both kinds by `mesh.param_specs`: codes, group scales and biases, w8 and
w8_scale along the output of a column-parallel linear; along the input,
groups alongside, for a row-parallel one, whose `row_parallel` leaves its
bias to the reduced sum.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from f5_tts_tpu_torch.ops.qmatmul import GROUP_SIZE, dequantize_kernel, qmatmul
from f5_tts_tpu_torch.ops.w8a8 import quantize_rows_plain, w8a8_linear, w8a8_row_parallel

__all__ = [
    "GROUP_SIZE", "QuantizedLinear", "W8A8Linear", "W8A8_TARGETS", "dequantize_kernel", "pack_mlx_uint32",
    "quantizable", "quantize_flat_mlx", "quantize_kernel", "quantize_module_", "unpack_mlx_uint32",
    "w8a8_blocks_", "w8a8_from_weight",
]


def unpack_mlx_uint32(w: np.ndarray, bits: int) -> np.ndarray:
    """MLX packed uint32 [out, in*bits/32] -> uint8 [out, in]
    (least-significant element first within each word)."""
    per = 32 // bits
    shifts = (np.arange(per, dtype=np.uint32) * bits).astype(np.uint32)
    vals = (w[..., None] >> shifts) & np.uint32((1 << bits) - 1)
    return vals.reshape(*w.shape[:-1], w.shape[-1] * per).astype(np.uint8)


def pack_mlx_uint32(q: np.ndarray, bits: int) -> np.ndarray:
    """uint8 [out, in] -> MLX packed uint32 [out, in*bits/32]."""
    per = 32 // bits
    q = q.astype(np.uint32, order="C").reshape(*q.shape[:-1], q.shape[-1] // per, per)
    shifts = (np.arange(per, dtype=np.uint32) * bits).astype(np.uint32)
    return (q << shifts).sum(axis=-1, dtype=np.uint32)


def quantize_kernel(kernel: np.ndarray, bits: int, group_size: int = GROUP_SIZE) -> dict[str, np.ndarray]:
    """Quantize a [in, out] kernel with per-group min/max affine groups of
    `group_size` inputs (mlx.nn.quantize semantics) -> {"q" int8 [in, out],
    "scales", "biases" float32 [in / group_size, out]}."""
    d_in, d_out = kernel.shape
    if d_in % group_size != 0:
        raise ValueError(f"in dim {d_in} not divisible by group size {group_size}")
    levels = (1 << bits) - 1
    g = kernel.reshape(d_in // group_size, group_size, d_out)
    w_min = g.min(axis=1)  # [groups, out]
    w_max = g.max(axis=1)
    offset = 1 << (bits - 1)
    scales = (w_max - w_min) / levels
    scales = np.where(scales == 0, 1e-8, scales).astype(np.float32)
    w_min = w_min.astype(np.float32)
    codes = np.rint((g - w_min[:, None, :]) / scales[:, None, :])
    codes = np.clip(codes, 0, levels)
    q = (codes - offset).astype(np.int8).reshape(d_in, d_out)
    return {"q": q, "scales": scales, "biases": (w_min + offset * scales).astype(np.float32)}


def quantizable(kernel_shape: tuple[int, ...]) -> bool:
    """A [in, out] kernel is quantized iff its input width is a multiple of 64."""
    return len(kernel_shape) == 2 and kernel_shape[0] % GROUP_SIZE == 0


def quantize_flat_mlx(flat: dict[str, np.ndarray], bits: int) -> dict[str, np.ndarray]:
    """Quantize an MLX-named flat dict into the published model_v1_{4,8}b
    convention: every eligible 2-D linear weight becomes packed uint32 codes
    plus per-group 'scales' and 'biases' siblings (the MLX offset
    convention: biases = group min); the text embedding table, the convs
    and the 712-wide input projection stay float."""
    qflat: dict[str, np.ndarray] = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if k.endswith(".weight") and v.ndim == 2 and quantizable(v.T.shape) \
                and not k.endswith("text_embed.text_embed.weight"):
            qp = quantize_kernel(v.T.astype(np.float32), bits)
            offset = 1 << (bits - 1)
            codes = (np.asarray(qp["q"]).astype(np.int16) + offset).astype(np.uint8).T
            qflat[k] = pack_mlx_uint32(codes, bits)
            qflat[k[:-7] + ".scales"] = np.ascontiguousarray(np.asarray(qp["scales"]).T)
            qflat[k[:-7] + ".biases"] = np.ascontiguousarray(
                np.asarray(qp["biases"] - offset * qp["scales"]).T)
        else:
            qflat[k] = v
    return qflat


class QuantizedLinear(nn.Module):
    """A linear with weight-only quantized weights, held as buffers: codes
    `q` int8 [out, in], `scales` and `biases` [out, in / 64], and the float
    `bias` [out] when the linear has one. The forward is `qmatmul`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device: torch.device | str | None = None):
        super().__init__()
        if in_features % GROUP_SIZE:
            raise ValueError(f"in_features {in_features} is not a multiple of {GROUP_SIZE}")
        self.in_features, self.out_features = in_features, out_features
        groups = in_features // GROUP_SIZE
        self.register_buffer("q", torch.zeros(out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scales", torch.zeros(out_features, groups, device=device))
        self.register_buffer("biases", torch.zeros(out_features, groups, device=device))
        self.register_buffer("bias", torch.zeros(out_features, device=device) if bias else None)

    @classmethod
    def from_linear(cls, lin: nn.Linear, bits: int) -> "QuantizedLinear":
        """Quantize a float linear's weight as `quantize_kernel` does."""
        weight = lin.weight.detach()
        out = cls(lin.in_features, lin.out_features, lin.bias is not None, device=weight.device)
        qp = quantize_kernel(weight.float().cpu().numpy().T, bits)
        for name in ("q", "scales", "biases"):
            getattr(out, name).copy_(torch.from_numpy(np.ascontiguousarray(qp[name].T)))
        if lin.bias is not None:
            out.bias.copy_(lin.bias.detach())
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qmatmul(x, self.q, self.scales, self.biases, self.bias)

    def row_parallel(self, x: torch.Tensor):
        """A generator: this slot's share as a row-parallel linear of a
        tensor-parallel group (models/blocks.py `row_parallel`): K3 without
        the bias, yielded for the group's sum; the bias is added once, to
        the sum."""
        total = yield "sum", qmatmul(x, self.q, self.scales, self.biases)
        return total if self.bias is None else total + self.bias.to(total.dtype)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}"


def quantize_module_(module: nn.Module, bits: int | None) -> nn.Module:
    """Swap every `nn.Linear` of `module` whose input width is a multiple of
    64 for a `QuantizedLinear`, in place: with `bits`, its weight quantized;
    with None, zero buffers of the right shapes for `load_state_dict` to
    fill. Returns `module`, which must be a DiT (ValueError)."""
    from f5_tts_tpu_torch.models.dit import require_dit

    require_dit(module, "quantize_module_ (int4/int8 weights)")
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Linear) and child.in_features % GROUP_SIZE == 0:
                if bits is None:
                    new = QuantizedLinear(child.in_features, child.out_features, child.bias is not None,
                                          device=child.weight.device)
                else:
                    new = QuantizedLinear.from_linear(child, bits)
                setattr(parent, name, new)
    return module


# ------------------------------------------------- int8-compute (W8A8) path


def w8a8_from_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float weight -> (w8 int8 [out, in], w8_scale float32 [out]):
    a symmetric absmax per output feature, the JAX package's
    `w8a8_from_kernel` in PyTorch's layout. It is the activations'
    per-row quantization applied to the weight's rows, on the weight's
    device."""
    return quantize_rows_plain(weight.detach())


class W8A8Linear(nn.Module):
    """A linear with int8 weights and int8 activations: buffers `w8` int8
    [out, in] (the layout torch._int_mm takes, as its transpose, without a
    copy), `w8_scale` float32 [out] and the float `bias` [out] when the
    linear has one. The forward is `w8a8_linear`."""

    def __init__(self, w8: torch.Tensor, w8_scale: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.out_features, self.in_features = w8.shape
        self.register_buffer("w8", w8)
        self.register_buffer("w8_scale", w8_scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "W8A8Linear":
        """Quantize a float linear's weight (in whatever dtype it holds) as
        `w8a8_from_weight` does; the bias keeps its dtype."""
        return cls(*w8a8_from_weight(lin.weight), None if lin.bias is None else lin.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return w8a8_linear(x, self.w8, self.w8_scale, self.bias)

    def row_parallel(self, x: torch.Tensor):
        """A generator: this slot's share as a row-parallel linear of a
        tensor-parallel group (ops/w8a8.py `w8a8_row_parallel`)."""
        return (yield from w8a8_row_parallel(x, self.w8, self.w8_scale, self.bias))

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}"


# the JAX package's _W8A8_TARGETS (attention to_q, to_k, to_v, to_out; FF w1, w2) by the port's module names
W8A8_TARGETS = ("attn.to_q", "attn.to_k", "attn.to_v", "attn.to_out.0", "ff.ff.0.0", "ff.ff.2")


def w8a8_blocks_(dit: nn.Module) -> nn.Module:
    """Swap the hot linears of every DiT block (`W8A8_TARGETS`) for
    `W8A8Linear`s, in place, and return `dit`. Everything outside the
    blocks' attention and feed-forward (AdaLN modulations, embeddings,
    proj_out) stays float, as in the JAX package. A weight-only quantized
    target raises ValueError: re-quantizing group-quantized weights per
    channel would compound two quantization errors. A model other than a
    DiT raises ValueError."""
    from f5_tts_tpu_torch.models.dit import require_dit

    require_dit(dit, "w8a8_blocks_ (W8A8 int8 compute)")
    for i, block in enumerate(dit.transformer_blocks):
        for target in W8A8_TARGETS:
            owner_name, _, name = target.rpartition(".")
            owner = block.get_submodule(owner_name)
            child = getattr(owner, name)
            if isinstance(child, QuantizedLinear):
                raise ValueError(
                    "int8_compute (W8A8) requires float kernels, but "
                    f"transformer_blocks.{i}.{target} is weight-only quantized "
                    "({q, scales, biases}). The --q snapshots and --w8a8 are "
                    "separate paths: load the float snapshot for int8 compute."
                )
            if isinstance(child, nn.Linear):
                setattr(owner, name, W8A8Linear.from_linear(child))
    return dit
