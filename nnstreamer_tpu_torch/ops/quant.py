"""Weight and activation quantization (symmetric int8).

The port's copy of the JAX package's ``ops/quant.py`` for the int8-head
path: per-output-channel int8 weights that dequantize on the fly, and the
dynamic per-tensor activation quantization that feeds the ``int8_matmul``
kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class QuantizedWeight:
    """Symmetric per-output-channel int8 weight: ``q`` (int8) and ``scale``
    (float32, broadcastable against ``q``)."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        # both factors in the target dtype, multiplied in it (bf16 * bf16 for
        # a bf16 model), as the JAX package does
        return self.q.to(dtype) * self.scale.to(dtype)


def quantize_weight(w, axis: int = -1) -> QuantizedWeight:
    """Symmetric int8 quantization per slice along ``axis`` (computed with
    numpy on the host, as in the JAX package)."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return QuantizedWeight(q=torch.from_numpy(q), scale=torch.from_numpy(scale))


def maybe_dequantize(w, dtype=None):
    """Materialize a weight leaf: dequantize a :class:`QuantizedWeight`,
    cast a float tensor to ``dtype`` when given."""
    if isinstance(w, QuantizedWeight):
        return w.dequantize(dtype if dtype is not None else torch.float32)
    if dtype is not None:
        return w.to(dtype)
    return w


def quantize_params(params):
    """Quantize every ``"w"`` leaf with ndim >= 2 of a dict/list tree to
    per-output-channel int8; everything else passes through.

    The tree is in the JAX package's layout (HWIO convs, (cin, cout) dense,
    output channel last, as numpy arrays), which is where per-channel
    quantization is defined."""

    def walk(node):
        if isinstance(node, dict):
            return {
                k: quantize_weight(v, axis=-1)
                if k == "w" and getattr(v, "ndim", 0) >= 2 else walk(v)
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


# XLA compiles ``amax / 127.0`` into ``amax * (1/127)`` (division by a
# constant becomes a product with its float32 reciprocal); the port computes
# the scale the same way so that it matches the compiled JAX model bit for bit.
_INV_127 = float(np.float32(1) / np.float32(127))


def quantize_activations(x: torch.Tensor, dtype=torch.int8):
    """Dynamic symmetric per-tensor quantization: ``(q, scale)`` with
    ``scale = max|x| / 127`` (1.0 for an all-zero tensor) and
    ``q = clip(round_half_even(x / scale), -127, 127)``.  ``scale`` stays a
    0-d device tensor, so nothing synchronizes with the host."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax * _INV_127, torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(dtype)
    return q, scale
