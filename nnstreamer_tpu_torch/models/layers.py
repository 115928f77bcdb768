"""Functional NN layers for the port's model zoo.

Params are plain dicts of tensors (OIHW conv kernels, (out, in, width) 1-D
conv kernels, (cin, cout) dense kernels).  Activations run NCHW-shaped inside a model; the models take and
give NHWC at their public functions, as the JAX package's do, and the NHWC
input seen through ``permute(0, 3, 1, 2)`` is a channels_last tensor, so no
copy is made.  Convs and dense layers are stock PyTorch: the JAX package
leaves them to XLA.  The full-int8 conv (:func:`conv2d_int8`) is an int8
product on ``torch._int_mm`` (XLA's in the JAX package) between a
quantize and a rescale.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.quant import (QuantizedWeight, int8_weight_matrix, int_mm, is_calibrating,
                         maybe_dequantize, mm_shape, quantize_activations, quantize_static)

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


_TINY = 1.17549435e-38  # float32's smallest normal


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it on the CPU: ``1 / (1 + exp(-x))``
    in ``x``'s dtype, each step rounded to it (in bfloat16 this differs from
    ``torch.sigmoid``, rounded once, on 1,116 of the 65,280 finite inputs),
    a subnormal result flushed to zero.  The pose net's bfloat16 heatmaps
    use it; float32 models, compared within a tolerance, use
    ``torch.sigmoid``."""
    r = torch.reciprocal(1 + torch.exp(-x))
    return torch.where(r.abs() < _TINY, r * 0, r)


def conv2d(params: Params, x: torch.Tensor, stride: int = 1, groups: int = 1,
           dtype=None, int8: bool = False) -> torch.Tensor:
    """SAME-padded conv of an NCHW tensor; depthwise with ``groups=C``.
    ``int8=True`` with an ungrouped quantized weight takes the full-int8
    path (:func:`conv2d_int8`); any other quantized weight dequantizes."""
    if int8 and groups == 1 and isinstance(params["w"], QuantizedWeight):
        return conv2d_int8(params, x, stride=stride, dtype=dtype)
    w = maybe_dequantize(params["w"], dtype)
    top, bottom = _same_pads(x.shape[2], w.shape[2], stride)
    left, right = _same_pads(x.shape[3], w.shape[3], stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left), groups=groups)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride, groups=groups)


class Int8Conv(NamedTuple):
    """An int8 conv's operands prepared once, at build time: the weight as
    ``int_mm``'s (K, N) matrix (rows in (kh, kw, cin) order, the HWIO
    flattening; padded, column-major), its per-channel scales as a padded
    row, and for a static ``act_scale`` the rescale ``f32(s) * w_scale``."""

    weight: QuantizedWeight  # the leaf this was made from
    act_scale: Optional[float]
    w_mat: torch.Tensor
    w_scale: torch.Tensor  # (Np,) float32, zeros in the padding
    rescale: Optional[torch.Tensor]  # (Np,) float32, static scales only
    kh: int
    kw: int
    cout: int


def int8_conv_operands(params: Params) -> Int8Conv:
    """The prepared operands of an int8 conv's param dict, kept under its
    ``"int8"`` key and made again when the weight or ``act_scale`` changed
    (calibration records a new scale a sample).  Nothing is kept while a
    CUDA graph is being captured: the model's builder prepares every conv
    (:func:`prepare_int8`), so a capture only reads them."""
    w = params["w"]
    act_scale = params.get("act_scale") or None
    prep = params.get("int8")
    if prep is not None and prep.weight is w and prep.act_scale == act_scale:
        return prep
    cout, cin, kh, kw = w.q.shape
    w_mat = int8_weight_matrix(w.q.permute(2, 3, 1, 0).reshape(kh * kw * cin, cout))
    npad = w_mat.shape[1]
    w_scale = torch.zeros((npad,), dtype=torch.float32, device=w.q.device)
    w_scale[:cout] = w.scale.reshape(-1)
    rescale = None
    if act_scale:
        rescale = torch.tensor(act_scale, dtype=torch.float32, device=w_scale.device) * w_scale
    prep = Int8Conv(w, act_scale, w_mat, w_scale, rescale, kh, kw, cout)
    if not (w.q.is_cuda and torch.cuda.is_current_stream_capturing()):
        params["int8"] = prep
    return prep


def prepare_int8(tree) -> None:
    """Prepare every quantized conv of a params tree (:func:`int8_conv_operands`)."""
    if isinstance(tree, dict):
        w = tree.get("w")
        if isinstance(w, QuantizedWeight) and w.q.dim() == 4:
            int8_conv_operands(tree)
        for v in tree.values():
            prepare_int8(v)
    elif isinstance(tree, list):
        for v in tree:
            prepare_int8(v)


def _im2col(q: torch.Tensor, kh: int, kw: int, stride: int, kp: int):
    """The (M, K) int8 matrix of an NCHW-shaped activation for a SAME conv:
    for each output pixel the ``kh * kw`` input pixels' channels, in (kh,
    kw, cin) order, zero-padded to ``kp`` columns; with the output size.  A
    1x1 stride-1 conv on channels_last activations is a view, no copy."""
    x = q.permute(0, 2, 3, 1)  # NHWC
    n, h, w, c = x.shape
    if kh == kw == 1 and stride == 1 and kp == c:
        return x.reshape(n * h * w, c), h, w
    top, bottom = _same_pads(h, kh, stride)
    left, right = _same_pads(w, kw, stride)
    x = F.pad(x, (0, 0, left, right, top, bottom))
    ho, wo = -(-h // stride), -(-w // stride)
    cols = [x[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
            for i in range(kh) for j in range(kw)]
    if kp > kh * kw * c:
        cols.append(x.new_zeros((n, ho, wo, kp - kh * kw * c)))
    return torch.cat(cols, dim=3).reshape(n * ho * wo, kp), ho, wo


def conv2d_int8(params: Params, x: torch.Tensor, stride: int = 1, dtype=None) -> torch.Tensor:
    """Full-int8 SAME conv of an NCHW tensor: int8 activations x int8
    weights → int32 → rescaled in float32, as the JAX package's
    ``layers.conv2d_int8``.

    - With a calibrated ``act_scale`` in the param dict: the static
      quantize, ``clip(round(x * f32(1/s)))`` (:func:`quantize_static`), and
      the rescale ``f32(s) * w_scale`` prepared at build time.
    - Without one (or a 0.0): one scale per sample (batch composition never
      changes a frame's numbers), rescale ``s * w_scale``.
    - While calibrating (this thread): record the raw running ``max|x| /
      127`` (a Python float, in float64) as ``act_scale``, then the dynamic
      path.

    The int8 matrix of the activations (:func:`_im2col`) times the prepared
    weight on ``torch._int_mm`` (:func:`int_mm`), then ``(acc * rescale)``
    in float32 rounded to ``dtype``, returned as an NCHW view."""
    w = params["w"]
    if not isinstance(w, QuantizedWeight):
        raise TypeError("conv2d_int8 needs a quantized weight")
    act_scale = params.get("act_scale")
    if is_calibrating():
        # eager calibration only: this reads the device
        prev = float(act_scale) if act_scale is not None else 0.0
        params["act_scale"] = max(prev, float(x.abs().amax()) / 127.0)
        act_scale = None
    prep = params.get("int8")
    if prep is None or prep.weight is not w or (act_scale and prep.act_scale != act_scale):
        prep = int8_conv_operands(params)
    q, rescale = _int8_quantize(x, act_scale, prep)
    a, ho, wo = _im2col(q, prep.kh, prep.kw, stride, prep.w_mat.shape[0])
    acc = int_mm(a, prep.w_mat)
    return _int8_rescale(acc, rescale, x.shape[0], ho, wo, prep.cout,
                         dtype if dtype is not None else torch.float32)


def _int8_quantize(x: torch.Tensor, act_scale, prep: Int8Conv):
    """An int8 conv's activations quantized, and the rescale of its
    accumulators: static (a float scale) or per sample."""
    if act_scale:
        return quantize_static(x, act_scale), prep.rescale.view(1, 1, -1)
    q, s = quantize_activations(x, axes=(1, 2, 3))
    return q, s.view(x.shape[0], 1, 1) * prep.w_scale.view(1, 1, -1)


def _int8_rescale(acc: torch.Tensor, rescale: torch.Tensor, n: int, ho: int, wo: int,
                  cout: int, dtype) -> torch.Tensor:
    """(M, Np) int32 accumulators → ``acc * rescale`` in float32, rounded to
    ``dtype``, as an NCHW view of the ``cout`` channels."""
    y = (acc.view(n, ho * wo, -1).to(torch.float32) * rescale).to(dtype)
    return y[..., :cout].view(n, ho, wo, cout).permute(0, 3, 1, 2)


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
                  dtype=None, act: bool = True, int8: bool = False) -> torch.Tensor:
    y = conv2d(params["conv"], x, stride=stride, groups=groups, dtype=dtype, int8=int8)
    y = batch_norm(params["bn"], y)
    return relu6(y) if act else y


def ensure_batched(x: torch.Tensor, rank: int) -> Tuple[torch.Tensor, bool]:
    """Add a batch dim if the stream frame is unbatched (rank-3 image)."""
    if x.dim() == rank - 1:
        return x[None], True
    return x, False
