"""Functional NN layers for the port's model zoo.

Params are plain dicts of tensors (OIHW conv kernels, (out, in, width) 1-D
conv kernels, (cin, cout) dense kernels).  Activations run NCHW-shaped inside a model; the models take and
give NHWC at their public functions, as the JAX package's do, and the NHWC
input seen through ``permute(0, 3, 1, 2)`` is a channels_last tensor, so no
copy is made.  Convs and dense layers are stock PyTorch: the JAX package
leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.quant import maybe_dequantize

Params = Dict[str, Any]


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of XLA's "SAME": the extra pixel of an odd
    total goes after, so a 3x3 stride-2 conv on an even input pads (0, 1),
    which ``nn.Conv2d(padding=1)`` does not reproduce.  The sizes are taken
    as Python ints, also under ``torch.jit.trace`` (which would otherwise
    record this arithmetic on size tensors, and a TorchScript file loaded
    onto the card would then read them back to the host inside a CUDA-graph
    capture): a traced model keeps the pads of its traced geometry."""
    size, k = int(size), int(k)
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(params: Params, x: torch.Tensor, stride: int = 1, groups: int = 1,
           dtype=None) -> torch.Tensor:
    """SAME-padded conv of an NCHW tensor; depthwise with ``groups=C``."""
    w = maybe_dequantize(params["w"], dtype)
    top, bottom = _same_pads(x.shape[2], w.shape[2], stride)
    left, right = _same_pads(x.shape[3], w.shape[3], stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left), groups=groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride, groups=groups)


def conv1d(params: Params, x: torch.Tensor, stride: int = 1, dtype=None) -> torch.Tensor:
    """SAME-padded 1-D conv of an (N, C, W) tensor, bias added: the JAX
    package's NWC/WIO ``conv_general_dilated`` with ``"SAME"``.  At a
    stride above 1 an odd padding total puts its extra sample after, which
    ``F.conv1d(padding="same")`` (stride 1 only) cannot express, so the
    input is padded explicitly.  With ``dtype`` the weight and bias are
    cast to it and the bias is added in it."""
    w, b = maybe_dequantize(params["w"], dtype), params["b"]
    if dtype is not None:
        b = b.to(dtype)
    low, high = _same_pads(x.shape[2], w.shape[2], stride)
    if low == high:
        return F.conv1d(x, w, stride=stride, padding=low) + b.view(1, -1, 1)
    return F.conv1d(F.pad(x, (low, high)), w, stride=stride) + b.view(1, -1, 1)


def batch_norm(params: Params, x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Inference BN over channels (dim 1).  The folded scale is cast to the
    compute dtype before the bias is folded with it, as in the JAX layer."""
    dtype = x.dtype
    scale = (params["scale"] / torch.sqrt(params["var"] + eps)).to(dtype)
    bias = (params["bias"] - params["mean"] * scale).to(dtype)
    return x * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def dense(params: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    w, b = maybe_dequantize(params["w"], dtype), params["b"]
    if dtype is not None:
        b = b.to(dtype)
    return x @ w + b


def conv_bn_relu6(params: Params, x: torch.Tensor, stride: int = 1, groups: int = 1,
                  dtype=None, act: bool = True) -> torch.Tensor:
    y = conv2d(params["conv"], x, stride=stride, groups=groups, dtype=dtype)
    y = batch_norm(params["bn"], y)
    return relu6(y) if act else y


def ensure_batched(x: torch.Tensor, rank: int) -> Tuple[torch.Tensor, bool]:
    """Add a batch dim if the stream frame is unbatched (rank-3 image)."""
    if x.dim() == rank - 1:
        return x[None], True
    return x, False
