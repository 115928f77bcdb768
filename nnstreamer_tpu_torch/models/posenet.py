"""PoseNet, the pose-estimation pipeline's model (BASELINE.md config 3).

The port of the JAX package's ``models/posenet.py``: the MobileNet-v2 trunk
truncated after block 13 (the 96-channel stage, stride 16) and a 1x1
heatmap head to 14 channels, a sigmoid on each, so that a 224x224 frame
gives (14, 14, 14) heatmaps, the ``pose_estimation`` decoder's input.
``build(fused_decode=True)`` appends :func:`decode_keypoints`, an argmax
per channel on the card, and emits (14, 3) keypoints instead.

Weights are random: :func:`init_params` seeds numpy from an int;
:func:`params_from_jax` takes the JAX package's own params instead.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..backends.torch_backend import TorchModel
from ..ops.quant import quantize_model
from ..spec import TensorSpec, TensorsSpec
from . import mobilenet_v2
from .layers import Params, conv2d, conv_bn_relu6, ensure_batched, prepare_int8, sigmoid

POSE_KEYPOINTS = 14
TRUNK_BLOCKS = 13  # through the 96-channel stage, stride 16


def init_tree(seed: int = 0, width_mult: float = 1.0) -> Params:
    """Random params in the JAX package's layout (HWIO numpy arrays)."""
    backbone = mobilenet_v2.init_tree(seed, 1, width_mult)
    blocks = backbone["blocks"][:TRUNK_BLOCKS]
    cin = blocks[-1]["project"]["conv"]["w"].shape[-1]
    rng = np.random.default_rng([seed, 1])
    w = rng.standard_normal((1, 1, cin, POSE_KEYPOINTS), dtype=np.float32)
    return {"stem": backbone["stem"], "blocks": blocks,
            "head": {"w": w * np.float32(np.sqrt(2.0 / cin))}}


def params_from_jax(tree: Any, device="cuda") -> Params:
    """The port's params from the JAX package's tree (numpy leaves)."""
    return mobilenet_v2.params_from_jax(tree, device)


def init_params(seed: int = 0, width_mult: float = 1.0, device="cuda") -> Params:
    """Random params from an int seed, in the port's layout on ``device``."""
    return params_from_jax(init_tree(seed, width_mult), device)


def apply(params: Params, x: torch.Tensor, dtype=torch.bfloat16, int8: bool = False):
    """(N,H,W,3) or (H,W,3) float input → (N,H/16,W/16,14) or (H/16,W/16,14)
    float32 heatmaps.  ``int8=True``: every ungrouped conv with a quantized
    weight (stem, expand and project, the heatmap head) runs int8 x int8 →
    int32; the depthwise convs stay in ``dtype``."""
    x, squeezed = ensure_batched(x, 4)
    y = x.to(dtype).permute(0, 3, 1, 2)  # NHWC → NCHW view (channels_last)
    y = conv_bn_relu6(params["stem"], y, stride=2, dtype=dtype, int8=int8)
    for block in params["blocks"]:
        y = mobilenet_v2._block_apply(block, y, dtype, int8=int8)
    hm = sigmoid(conv2d(params["head"], y, dtype=dtype, int8=int8).to(dtype))
    hm = hm.to(torch.float32).permute(0, 2, 3, 1).contiguous()
    return hm[0] if squeezed else hm


def decode_keypoints(hm: torch.Tensor) -> torch.Tensor:
    """(…,H,W,14) heatmaps → (…,14,3) rows of ``[x, y, score]`` in grid
    coordinates: the argmax of each channel (the first cell of equal
    maxima, as ``jnp.argmax`` and numpy take it), on the heatmaps' device."""
    squeezed = hm.dim() == 3
    if squeezed:
        hm = hm[None]
    n, h, w, k = hm.shape
    flat = hm.reshape(n, h * w, k)
    idx = torch.argmax(flat, dim=1)
    score = torch.gather(flat, 1, idx[:, None, :])[:, 0, :]
    xs = (idx % w).to(torch.float32)
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    out = torch.stack([xs, ys, score], dim=-1)
    return out[0] if squeezed else out


def grid_size(image_size: int = 224) -> int:
    return image_size // 16


def build(image_size: int = 224, batch: Optional[int] = None, dtype=torch.bfloat16,
          seed: int = 0, params: Optional[Params] = None, fused_decode: bool = False,
          int8: bool = False, device="cuda") -> TorchModel:
    """A stream-ready pose net.  ``fused_decode=True`` appends
    :func:`decode_keypoints`: the model emits (14, 3) keypoints that the
    ``pose_estimation`` decoder takes as they are.  ``int8=True`` routes
    the convs with quantized weights through the int8 path (pass quantized
    params, or use :func:`build_quantized`).  ``params``, when given, is a
    tree in the JAX package's layout (numpy leaves)."""
    tree = params if params is not None else init_tree(seed)
    lead: Tuple[int, ...] = (batch,) if batch is not None else ()
    g = grid_size(image_size)
    if fused_decode:
        def fwd(p, x):
            return decode_keypoints(apply(p, x, dtype=dtype, int8=int8))

        out = TensorSpec(dtype=np.float32, shape=lead + (POSE_KEYPOINTS, 3))
    else:
        def fwd(p, x):
            return apply(p, x, dtype=dtype, int8=int8)

        out = TensorSpec(dtype=np.float32, shape=lead + (g, g, POSE_KEYPOINTS))
    return TorchModel(
        apply=fwd, params=params_from_jax(tree, device),
        input_spec=TensorsSpec.of(
            TensorSpec(dtype=np.float32, shape=lead + (image_size, image_size, 3))),
        output_spec=TensorsSpec.of(out),
        name="posenet_mobilenet_v2", device=device,
    )


def build_quantized(image_size: int = 224, batch: Optional[int] = None, dtype=torch.bfloat16,
                    seed: int = 0, params: Optional[Params] = None,
                    fused_decode: bool = False, device="cuda") -> TorchModel:
    """Full-int8 pose net, as the JAX package's: every ungrouped conv (stem,
    expand and project, the heatmap head) runs int8 x int8 → int32 with
    per-sample activation scales, its weight stored per output channel and
    prepared for the int8 product once, here.  The head's 14 columns are
    padded to the int8 GEMM's multiple of 8 (``ops/quant.py::int_mm``)."""
    m = quantize_model(build(image_size, batch, dtype, seed, params,
                             fused_decode=fused_decode, int8=True, device=device))
    prepare_int8(m.params)
    return m
