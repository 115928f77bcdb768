"""MobileNet-v2 (Sandler et al. 2018), the image-labeling pipeline's model.

The port of the JAX package's ``models/mobilenet_v2.py``: the same
inverted-residual network and params tree, bf16 compute over float32
params, NHWC in and logits out.  :func:`build_quantized` stores every conv
and dense kernel as int8: ``int8_head=True`` runs the classifier on the
hand-written ``int8_matmul`` kernel, ``int8_convs=True`` every ungrouped
conv int8 x int8 → int32 (:func:`~.layers.conv2d_int8`), with per-sample
activation scales or, with ``static_scales=True``, scales calibrated once
at build time.

Weights are random.  :func:`init_params` seeds numpy from an int (the JAX
package seeds it from a JAX key, so the two draw different weights);
:func:`params_from_jax` takes the JAX package's own params instead, and
:func:`params_to_jax` gives a port tree back in that layout.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backends.torch_backend import TorchModel
from ..device import resolve_device
from ..ops.kernels import int8_matmul
from ..ops.quant import (QuantizedWeight, calibrate_static_scales, quantize_activations,
                         quantize_params)
from ..spec import TensorSpec, TensorsSpec
from .layers import Params, conv_bn_relu6, dense, ensure_batched, prepare_int8

# (expansion t, out channels c, repeats n, stride s): the paper's Table 2.
_CFG: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def init_tree(seed: int, num_classes: int, width_mult: float) -> Params:
    """Random params in the JAX package's layout (HWIO numpy arrays)."""
    rng = np.random.default_rng(seed)

    def normal(shape, stddev):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(stddev)

    def cbr(kh, kw, cin, cout, groups=1):
        fan_in = kh * kw * cin // groups
        return {
            "conv": {"w": normal((kh, kw, cin // groups, cout), np.sqrt(2.0 / fan_in))},
            "bn": {"scale": np.ones((cout,), np.float32), "bias": np.zeros((cout,), np.float32),
                   "mean": np.zeros((cout,), np.float32), "var": np.ones((cout,), np.float32)},
        }

    params: Params = {}
    cin = _make_divisible(32 * width_mult)
    params["stem"] = cbr(3, 3, 3, cin)
    blocks = []
    for t, c, n, s in _CFG:
        cout = _make_divisible(c * width_mult)
        for i in range(n):
            hidden = cin * t
            block: Params = {}
            if t != 1:
                block["expand"] = cbr(1, 1, cin, hidden)
            block["depthwise"] = cbr(3, 3, hidden, hidden, groups=hidden)
            block["project"] = cbr(1, 1, hidden, cout)
            block["stride"] = s if i == 0 else 1
            block["residual"] = block["stride"] == 1 and cin == cout
            blocks.append(block)
            cin = cout
    params["blocks"] = blocks
    chead = _make_divisible(1280 * max(1.0, width_mult))
    params["head"] = cbr(1, 1, cin, chead)
    params["classifier"] = {"w": normal((chead, num_classes), np.sqrt(1.0 / chead)),
                            "b": np.zeros((num_classes,), np.float32)}
    return params


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A contiguous copy of ``a`` on ``device`` (the caller's arrays may be
    read-only views)."""
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _weight_from_jax(w: Any, device) -> Any:
    """A ``"w"`` leaf: HWIO conv → OIHW (a depthwise (3,3,1,C) → (C,1,3,3));
    a (cin, cout) dense kernel stays.  A quantized leaf is read by its
    ``.q`` / ``.scale`` attributes and its scale reshaped to match."""
    if hasattr(w, "q") and hasattr(w, "scale"):
        q, scale = np.asarray(w.q), np.asarray(w.scale, np.float32)
        if q.ndim == 4:
            q, scale = q.transpose(3, 2, 0, 1), scale.reshape(-1, 1, 1, 1)
        else:
            scale = scale.reshape(1, -1)
        return QuantizedWeight(_tensor(q, device), _tensor(scale, device))
    w = np.asarray(w, np.float32)
    if w.ndim == 4:
        w = w.transpose(3, 2, 0, 1)
    return _tensor(w, device)


def params_from_jax(tree: Any, device="cuda") -> Params:
    """The port's params from the JAX package's params tree, whose leaves
    the caller has turned into numpy arrays (``QuantizedWeight`` leaves
    keep their ``q`` / ``scale`` as numpy arrays)."""
    dev = resolve_device(device)

    def walk(node, key=None):
        if key == "w":
            return _weight_from_jax(node, dev)
        if key == "act_scale":  # a calibrated scale stays a Python float
            return float(np.asarray(node))
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        arr = np.asarray(node)
        if arr.ndim == 0 and arr.dtype.kind in "biu":
            return arr.item()  # block "stride" / "residual" (0-d once numpy'd)
        return _tensor(arr.astype(np.float32), dev)

    return walk(tree)


def params_to_jax(tree: Any) -> Params:
    """The JAX package's params layout (numpy leaves, HWIO conv kernels)
    from the port's (host or device tensors, or the numpy arrays a
    trainer's ``params`` gives): the inverse of :func:`params_from_jax` for
    a float tree, so trained parameters go back to ``build(params=...)``
    or to the JAX package."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if isinstance(node, torch.Tensor):
            node = node.detach().cpu().numpy()
        if isinstance(node, np.ndarray):
            return node.transpose(2, 3, 1, 0) if key == "w" and node.ndim == 4 else node
        return node

    return walk(tree)


def init_params(seed: int = 0, num_classes: int = 1001, width_mult: float = 1.0,
                device="cuda") -> Params:
    """Random params from an int seed, in the port's layout on ``device``."""
    return params_from_jax(init_tree(seed, num_classes, width_mult), device)


def _block_apply(block: Params, x: torch.Tensor, dtype, int8: bool = False) -> torch.Tensor:
    y = x
    if "expand" in block:
        y = conv_bn_relu6(block["expand"], y, dtype=dtype, int8=int8)
    y = conv_bn_relu6(block["depthwise"], y, stride=block["stride"], groups=y.shape[1],
                      dtype=dtype)
    y = conv_bn_relu6(block["project"], y, dtype=dtype, act=False, int8=int8)
    if block["residual"]:
        y = y + x
    return y


def features(params: Params, x: torch.Tensor, dtype=torch.bfloat16,
             int8: bool = False) -> torch.Tensor:
    """Trunk and global average pool: (N, H, W, 3) → (N, C) in ``dtype``.
    ``int8=True``: every ungrouped conv with a quantized weight runs int8
    (the depthwise convs stay in ``dtype``)."""
    y = x.to(dtype).permute(0, 3, 1, 2)  # NHWC → NCHW view (channels_last)
    y = conv_bn_relu6(params["stem"], y, stride=2, dtype=dtype, int8=int8)
    for block in params["blocks"]:
        y = _block_apply(block, y, dtype, int8=int8)
    y = conv_bn_relu6(params["head"], y, dtype=dtype, int8=int8)
    return y.mean(dim=(2, 3))


def apply(params: Params, x: torch.Tensor, dtype=torch.bfloat16, int8: bool = False) -> torch.Tensor:
    """(N,H,W,3) or (H,W,3) float input → (N,classes) or (classes,) float32
    logits; ``int8`` as :func:`features`."""
    x, squeezed = ensure_batched(x, 4)
    logits = dense(params["classifier"], features(params, x, dtype, int8), dtype=dtype)
    logits = logits.to(torch.float32)
    return logits[0] if squeezed else logits


def int8_head(head: Params, feats: torch.Tensor) -> torch.Tensor:
    """The quantized classifier: per-tensor dynamic activation quantization
    of float32 features, then the ``int8_matmul`` kernel."""
    w = head["w"]
    if not isinstance(w, QuantizedWeight):
        raise TypeError("int8 head needs a quantized classifier weight")
    q, scale = quantize_activations(feats.to(torch.float32))
    return int8_matmul(q, w.q, scale, w.scale, head["b"])


def apply_quantized_int8_head(params: Params, x: torch.Tensor, dtype=torch.bfloat16,
                              int8: bool = False) -> torch.Tensor:
    """Forward pass with the classifier on the int8 kernel; ``int8=True``
    runs the conv trunk full-int8 as well."""
    x, squeezed = ensure_batched(x, 4)
    logits = int8_head(params["classifier"], features(params, x, dtype, int8))
    return logits[0] if squeezed else logits


def _spec(image_size: int, batch: Optional[int], num_classes: int):
    shape: Tuple[int, ...] = (image_size, image_size, 3)
    out: Tuple[int, ...] = (num_classes,)
    if batch is not None:
        shape, out = (batch,) + shape, (batch, num_classes)
    return (TensorsSpec.of(TensorSpec(dtype=np.float32, shape=shape)),
            TensorsSpec.of(TensorSpec(dtype=np.float32, shape=out)))


def build(num_classes: int = 1001, width_mult: float = 1.0, image_size: int = 224,
          batch: Optional[int] = None, dtype=torch.bfloat16, seed: int = 0,
          params: Optional[Params] = None, device="cuda") -> TorchModel:
    """A stream-ready float model.  ``params``, when given, is a tree in the
    JAX package's layout (numpy leaves, see :func:`params_from_jax`)."""
    tree = params if params is not None else init_tree(seed, num_classes, width_mult)
    in_spec, out_spec = _spec(image_size, batch, num_classes)
    return TorchModel(
        apply=lambda p, x: apply(p, x, dtype=dtype),
        params=params_from_jax(tree, device),
        input_spec=in_spec, output_spec=out_spec,
        name=f"mobilenet_v2_{width_mult}_{image_size}", device=device,
    )


def build_quantized(num_classes: int = 1001, width_mult: float = 1.0,
                    image_size: int = 224, batch: Optional[int] = None,
                    dtype=torch.bfloat16, seed: int = 0,
                    params: Optional[Params] = None, int8_head: bool = False,
                    int8_convs: bool = False, static_scales: bool = False,
                    calib_samples: int = 4, calib_data=None,
                    device="cuda") -> TorchModel:
    """Int8-weight model: every conv and dense kernel is stored as
    per-channel int8 and dequantized in ``dtype`` on the fly, as the JAX
    package's ``build_quantized``.

    - ``int8_convs=True``: every ungrouped conv runs int8 x int8 → int32
      (``torch._int_mm``), activations quantized per sample.
    - ``static_scales=True`` (with ``int8_convs`` or ``int8_head``): the
      activation scales are calibrated once here, on the CPU, over
      ``calib_data`` (normalized (H, W, 3) frames) or ``calib_samples``
      uniform [-1, 1] frames from ``seed + 1``, and the quantize becomes
      elementwise.  ``params`` may carry calibrated ``act_scale`` leaves
      already (the JAX package's own, say); they are used as they are.
    - ``int8_head=True``: the classifier runs on the ``int8_matmul``
      kernel; it composes with ``int8_convs``.
    Each int8 conv's weight matrix and rescale are prepared here, once."""
    tree = params if params is not None else init_tree(seed, num_classes, width_mult)
    if int8_head:
        def fwd(p, x, dtype=dtype, _i8=int8_convs):
            return apply_quantized_int8_head(p, x, dtype=dtype, int8=_i8)
    elif int8_convs:
        def fwd(p, x, dtype=dtype):
            return apply(p, x, dtype=dtype, int8=True)
    else:
        fwd = apply
    qparams = params_from_jax(quantize_params(tree), device)
    if static_scales and (int8_convs or int8_head):
        if calib_data is not None:
            samples = [np.asarray(x, np.float32) for x in calib_data]
            if not samples:
                raise ValueError("calib_data is empty")
        else:
            rng = np.random.default_rng(seed + 1)
            samples = [rng.uniform(-1.0, 1.0, (image_size, image_size, 3)).astype(np.float32)
                       for _ in range(max(1, calib_samples))]
        calibrate_static_scales(lambda p, x: apply(p, x, dtype=dtype, int8=True), qparams,
                                samples)
    if int8_convs:
        prepare_int8(qparams)
    in_spec, out_spec = _spec(image_size, batch, num_classes)
    return TorchModel(
        apply=lambda p, x: fwd(p, x, dtype=dtype),
        params=qparams,
        input_spec=in_spec, output_spec=out_spec,
        name=f"mobilenet_v2_q8_{width_mult}_{image_size}", device=device,
    )
