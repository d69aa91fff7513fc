"""Weight-only int8 quantization for the LLM serving path (the port of
``repro.serve.quantized``): the paper's Eq. 1, symmetric, per output
channel, with scales fixed ahead of time. Activations stay float; each
serve step dequantizes the weights it runs with.

A stacked leaf (``(n_periods, ...)``, and for MoE ``(n_periods, E, ...)``)
is quantized as one tensor, as the reference does: its scale is the absmax
over every axis but the last, so one scale per output channel is shared by
all periods and all experts, and ``min_size`` counts the stack too.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.layers import tree_map


@dataclasses.dataclass
class QuantizedTensor:
    """int8 values + per-output-channel scales (Eq. 1 with Z = 0)."""
    q: torch.Tensor       # int8
    scale: torch.Tensor   # float32, shape (out_channels,)
    orig_dtype: torch.dtype = torch.float32

    def dequantize(self) -> torch.Tensor:
        return (self.q.float() * self.scale).to(self.orig_dtype)


def quantize_tensor(leaf, min_size: int = 1 << 12):
    """``leaf`` as a :class:`QuantizedTensor` if it is a float matrix (or a
    stack of them) of at least ``min_size`` elements, else unchanged."""
    if (not torch.is_tensor(leaf) or not leaf.is_floating_point()
            or leaf.ndim < 2 or leaf.numel() < min_size):
        return leaf
    f = leaf.detach().float()
    red = tuple(range(leaf.ndim - 1))  # all but the output channel
    absmax = f.abs().amax(dim=red).clamp_min(1e-9)
    # tensor / tensor: a true division on every device (a CUDA tensor
    # divided by a host scalar is a multiply by its reciprocal)
    scale = absmax / torch.full_like(absmax, 127.0)
    qv = torch.round(f / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedTensor(qv, scale, leaf.dtype)


def quantize_params(params, min_size: int = 1 << 12):
    """int8-quantize every float matrix leaf of a tree of dicts and lists
    (per output channel, symmetric); small leaves (norms, biases) stay
    float."""
    return tree_map(lambda leaf: quantize_tensor(leaf, min_size), params)


def dequantize_params(qparams):
    """int8 -> the leaf's dtype, on the leaf's device."""
    return tree_map(lambda leaf: leaf.dequantize()
                    if isinstance(leaf, QuantizedTensor) else leaf, qparams)


def param_bytes(tree) -> int:
    total = 0

    def count(leaf):
        nonlocal total
        for t in ((leaf.q, leaf.scale) if isinstance(leaf, QuantizedTensor)
                  else (leaf,)):
            total += t.numel() * t.element_size()
    tree_map(count, tree)
    return total
