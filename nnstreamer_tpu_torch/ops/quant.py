"""Weight and activation quantization (symmetric int8), and calibration.

The port's copy of the JAX package's ``ops/quant.py``: per-output-channel
int8 weights that dequantize on the fly; dynamic activation quantization
(per tensor, or per sample for a batch) and its static counterpart with a
calibrated scale; :func:`int_mm`, the int8 x int8 → int32 product the
full-int8 convs and :func:`matmul_int8` run on (``torch._int_mm``: the JAX
package leaves this product to XLA, so a library call is its port); and
the calibration that records each int8 conv's static scale.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
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


def _quantize_np(w: np.ndarray, axis: int):
    """``(q, scale)`` of the JAX package's ``quantize_weight``, in numpy:
    the scale keeps ``w``'s rank, 1 along every axis but ``axis``."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_weight(w, axis: int = -1) -> QuantizedWeight:
    """Symmetric int8 quantization per slice along ``axis`` (computed with
    numpy on the host, as in the JAX package)."""
    q, scale = _quantize_np(w, axis)
    return QuantizedWeight(q=torch.from_numpy(q), scale=torch.from_numpy(scale))


def maybe_dequantize(w, dtype=None):
    """Materialize a weight leaf: dequantize a :class:`QuantizedWeight`,
    cast a float tensor to ``dtype`` when given."""
    if isinstance(w, QuantizedWeight):
        return w.dequantize(dtype if dtype is not None else torch.float32)
    if dtype is not None:
        return w.to(dtype)
    return w


def dequantize(qw: QuantizedWeight, dtype=torch.float32) -> torch.Tensor:
    return qw.dequantize(dtype)


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


def _quantize_leaf(w: torch.Tensor) -> QuantizedWeight:
    """A weight in the port's layout, quantized per output channel: axis 0
    of an OIHW, depthwise (C,1,3,3) or (out, in, width) kernel, the last
    axis of a (cin, cout) dense kernel; the same q and scale as the JAX
    package's HWIO ``axis=-1`` quantization of the same weight."""
    q, scale = _quantize_np(w.detach().to("cpu", torch.float32).numpy(), 0 if w.dim() > 2 else -1)
    return QuantizedWeight(torch.from_numpy(q).to(w.device), torch.from_numpy(scale).to(w.device))


def quantize_model(m, name_suffix: str = "_q8"):
    """A built ``TorchModel`` with every ``"w"`` leaf of ndim >= 2 stored as
    per-output-channel int8: same apply and specs, ``name + suffix``.  The
    forward must already dispatch on the leaf type (``int8=`` conv flags)."""
    from ..backends.torch_backend import TorchModel

    def walk(node):
        if isinstance(node, dict):
            return {k: _quantize_leaf(v) if k == "w" and isinstance(v, torch.Tensor)
                    and v.dim() >= 2 else walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return TorchModel(apply=m.apply, params=walk(m.params), input_spec=m.input_spec,
                      output_spec=m.output_spec, name=m.name + name_suffix, device=m.device)


# XLA compiles ``amax / 127.0`` into ``amax * (1/127)`` (division by a
# constant becomes a product with its float32 reciprocal); the port computes
# the scale the same way so that it matches the compiled JAX model bit for
# bit.  Calibration runs the JAX model eagerly, where the division stays a
# true division (ROADMAP C11), so there the port divides too.
_INV_127 = float(np.float32(1) / np.float32(127))


def quantize_activations(x: torch.Tensor, dtype=torch.int8, axes=None):
    """Dynamic symmetric quantization: ``(q, scale)`` with ``scale = max|x|
    / 127`` (1.0 where that max is 0) and ``q = clip(round_half_even(x /
    scale), -127, 127)``.

    ``axes=None``: one scale for the tensor (0-d).  ``axes=(1, 2, 3)`` on an
    NCHW batch (or ``(-1,)`` on rows): one scale per sample (shape
    ``(N, 1, 1, 1)``), so a frame's numbers do not depend on the frames it
    is batched with.  The max and the scale are computed in ``x``'s dtype,
    as XLA computes them (a bfloat16 ``amax / 127`` is the float32 product
    with the reciprocal, rounded to bfloat16); the quotient ``x / scale`` is
    a true division in float32, the scale being no constant.  ``scale``
    stays a device tensor, so nothing synchronizes with the host.  While
    :func:`is_calibrating`, ``amax / 127`` is a true division, as the JAX
    package's eager calibration computes it."""
    a = x.abs()
    amax = a.amax() if axes is None else a.amax(dim=tuple(axes), keepdim=True)
    wide = amax.to(torch.float32)
    scale = wide / 127.0 if is_calibrating() else wide * _INV_127
    scale = scale.to(x.dtype).to(torch.float32)
    scale = torch.where(amax > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(dtype)
    return q, scale


def static_inverse(scale: float) -> float:
    """The float32 reciprocal of a static scale, as XLA folds ``x / s``
    for a scale it sees as a constant (the JAX backend closes over the
    params): ``x * f32(1 / f32(s))``."""
    return float(np.float32(1) / np.float32(scale))


def quantize_static(x: torch.Tensor, scale: float, dtype=torch.int8) -> torch.Tensor:
    """Quantize with a fixed (calibrated) ``scale``: ``clip(round(x *
    f32(1/s)), -127, 127)``, elementwise, no reduction.  The product with
    the reciprocal is what the JAX package's ``x / s`` compiles to with the
    scale closed over."""
    q = torch.round(x.to(torch.float32) * static_inverse(scale))
    return torch.clamp(q, -127, 127).to(dtype)


# torch._int_mm on CUDA (cuBLASLt's int8 GEMM) takes M > 16 and K, N that
# are multiples of 8; the port pads every operand to that on every device.
MM_MIN_M = 17
MM_ALIGN = 8


def mm_shape(m: int, k: int, n: int):
    """The padded (M, K, N) of an int8 product."""
    up = lambda v: -(-v // MM_ALIGN) * MM_ALIGN  # noqa: E731
    return max(up(m), up(MM_MIN_M)), up(k), up(n)


def int8_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) int8 weight as ``int_mm`` takes it: padded with zeros to
    :func:`mm_shape` and column-major (each column's K bytes contiguous)."""
    k, n = w.shape
    _, kp, np_ = mm_shape(1, k, n)
    t = torch.zeros((np_, kp), dtype=torch.int8, device=w.device)
    t[:n, :k] = w.t()
    return t.t()


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ b (Kp, Np) int8 → (M, Np) int32`` exactly, ``b``
    from :func:`int8_weight_matrix`: ``a`` is padded with zero rows and
    columns to the shape ``torch._int_mm`` takes."""
    m, k = a.shape
    mp, kp, _ = mm_shape(m, k, b.shape[1])
    if (mp, kp) != (m, k) or not a.is_contiguous():
        padded = torch.zeros((mp, kp), dtype=torch.int8, device=a.device)
        padded[:m, :k] = a
        a = padded
    return torch._int_mm(a, b)[:m]


def matmul_int8(x: torch.Tensor, qw: QuantizedWeight, dtype=torch.float32) -> torch.Tensor:
    """W8A8 ``(..., d) @ (d, dout)``: int8 operands, int32 accumulation,
    one scale per row (``axes=(-1,)``), the product rescaled by ``row scale
    * channel scale`` in float32."""
    q, s = quantize_activations(x, axes=(-1,))
    dout = qw.q.shape[1]
    y = int_mm(q.reshape(-1, q.shape[-1]), int8_weight_matrix(qw.q))[:, :dout]
    y = y.reshape(*q.shape[:-1], dout)
    rescale = s * qw.scale.reshape(-1).to(torch.float32)
    return (y.to(torch.float32) * rescale).to(dtype)


# -- static-scale calibration ----------------------------------------------

# Thread-local, as in the JAX package: calibrating on one thread must not
# turn another thread's int8 convs to the recording branch.
_CALIBRATING = threading.local()


def is_calibrating() -> bool:
    """Whether this thread calibrates (a thread-local flag: no tensor is
    read, so an int8 conv may ask inside a CUDA-graph capture)."""
    return getattr(_CALIBRATING, "active", False)


@contextmanager
def calibration():
    """While active on this thread, int8 convs run their dynamic path and
    record the raw running ``max|x| / 127`` as a float ``act_scale`` in
    their own param dict (the zero floor is applied once, at the end of
    :func:`calibrate_static_scales`)."""
    prev = getattr(_CALIBRATING, "active", False)
    _CALIBRATING.active = True
    try:
        yield
    finally:
        _CALIBRATING.active = prev


def _to_device(tree, device):
    """A copy of a params tree with its tensors on ``device``; dicts and
    lists are new, so a conv records its scale into the copy."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(tree.q.to(device), tree.scale.to(device))
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _copy_act_scales(src, dst) -> None:
    """Every ``act_scale`` of ``src`` into the dict at the same place in
    ``dst`` (two trees of the same structure)."""
    if isinstance(src, dict):
        if "act_scale" in src:
            dst["act_scale"] = src["act_scale"]
        for k, v in src.items():
            if isinstance(v, (dict, list)):
                _copy_act_scales(v, dst[k])
    elif isinstance(src, list):
        for a, b in zip(src, dst):
            _copy_act_scales(a, b)


def calibrate_static_scales(apply_fn, params, samples, device="cpu"):
    """Run ``apply_fn(params, x)`` over the calibration ``samples`` (NHWC
    float arrays or tensors) with :func:`calibration` active; every int8
    conv records a static ``act_scale``, floored once at the end
    (:func:`_floor_act_scales`), written into ``params``' own dicts.

    By default the forwards run on the CPU, on a CPU copy of the params,
    as the JAX package calibrates: the recorded scales are values, not
    timings.  ``device=None`` runs them on ``params`` where they lie."""
    work = params if device is None else _to_device(params, torch.device(device))
    with torch.no_grad(), calibration():
        for x in samples:
            x = torch.as_tensor(np.asarray(x, np.float32)) if not isinstance(x, torch.Tensor) else x
            apply_fn(work, x.to(torch.device(device)) if device is not None else x)
    _floor_act_scales(work)
    if work is not params:
        _copy_act_scales(work, params)
    return params


def _floor_act_scales(tree) -> None:
    """The zero guard, once, after all samples: an ``act_scale`` still 0.0
    (every sample was all zero) becomes 1.0.  Flooring per sample would
    pin the scale at 1.0 or more after one all-zero sample."""
    if isinstance(tree, dict):
        v = tree.get("act_scale")
        if isinstance(v, (int, float)) and not v:
            tree["act_scale"] = 1.0
        for child in tree.values():
            _floor_act_scales(child)
    elif isinstance(tree, (list, tuple)):
        for child in tree:
            _floor_act_scales(child)
