"""SSD-MobileNet-v2, the object-detection pipeline's model.

The port of the JAX package's ``models/ssd_mobilenet.py``: the MobileNet-v2
trunk tapped after block 12 (96 channels, stride 16) and after the last
block (320 channels, stride 32), four stride-2 extra blocks, and a 3x3 box
head and class head on each of the six feature maps.  For a 300x300 input
the grids are 19/10/5/3/2/1 with 3 or 6 anchors per cell, 1917 anchors in
all, in (row, col, anchor) order: the heads run NCHW here and are permuted
to NHWC before the reshape, so each anchor meets its prior.

:func:`decode_topk` is the on-device decode head of ``build(fused_decode=K)``
(sigmoid, best class, top K, prior decode), emitting the ``(K, 6)`` tensor
the ``fused-ssd`` decoder takes.  Weights are random: :func:`init_params`
seeds numpy from an int; :func:`params_from_jax` takes the JAX package's
own params instead.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..backends.torch_backend import TorchModel
from ..ops.kernels import _reciprocal
from ..ops.quant import quantize_model
from ..spec import TensorSpec, TensorsSpec
from . import mobilenet_v2
from .layers import Params, conv2d, conv_bn_relu6, ensure_batched, prepare_int8

# anchors per cell at the six detection scales (tflite-SSD convention)
ANCHORS_PER_SCALE: Tuple[int, ...] = (3, 6, 6, 6, 6, 6)
EXTRA_CHANNELS: Tuple[int, ...] = (256, 256, 128, 128)
_F32 = np.dtype(np.float32)


def feature_grids(image_size: int = 300) -> Tuple[Tuple[int, int], ...]:
    """(grid, anchors) per feature map: taps at stride 16 and 32, then four
    stride-2 "SAME" extras, each a ceil-halving.  300 → 19/10/5/3/2/1."""
    g = [-(-image_size // 16), -(-image_size // 32)]
    for _ in range(4):
        g.append(max(1, -(-g[-1] // 2)))
    return tuple(zip(g, ANCHORS_PER_SCALE))


def num_priors(image_size: int = 300) -> int:
    return sum(g * g * a for g, a in feature_grids(image_size))


FEATURE_GRIDS = feature_grids(300)
NUM_PRIORS = num_priors(300)  # 1917


def _init_tree(seed: int, num_labels: int, width_mult: float) -> Params:
    """Random params in the JAX package's layout (HWIO numpy arrays)."""
    backbone = mobilenet_v2.init_tree(seed, 1, width_mult)
    rng = np.random.default_rng([seed, 1])

    def conv(cin, cout):
        std = np.sqrt(2.0 / (9 * cin))
        return {"w": rng.standard_normal((3, 3, cin, cout), dtype=np.float32) * np.float32(std)}

    def bn(c):
        return {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32),
                "mean": np.zeros((c,), np.float32), "var": np.ones((c,), np.float32)}

    params: Params = {"stem": backbone["stem"], "blocks": backbone["blocks"]}
    c19 = params["blocks"][12]["project"]["conv"]["w"].shape[-1]
    c10 = params["blocks"][-1]["project"]["conv"]["w"].shape[-1]
    extras, cin = [], c10
    for c in EXTRA_CHANNELS:
        extras.append({"conv": conv(cin, c), "bn": bn(c)})
        cin = c
    params["extras"] = extras
    cins = (c19, c10) + EXTRA_CHANNELS
    params["box_heads"] = [conv(c, a * 4) for c, a in zip(cins, ANCHORS_PER_SCALE)]
    params["cls_heads"] = [conv(c, a * num_labels) for c, a in zip(cins, ANCHORS_PER_SCALE)]
    params["num_labels"] = num_labels
    return params


def params_from_jax(tree: Any, device="cuda") -> Params:
    """The port's params from the JAX package's params tree, whose leaves
    the caller has turned into numpy arrays: every ``"w"`` leaf becomes an
    OIHW tensor on ``device``, as :func:`mobilenet_v2.params_from_jax`
    does for the trunk."""
    params = mobilenet_v2.params_from_jax(tree, device)
    params["num_labels"] = int(params["num_labels"])
    return params


def init_params(seed: int = 0, num_labels: int = 91, width_mult: float = 1.0,
                device="cuda") -> Params:
    """Random params from an int seed, in the port's layout on ``device``."""
    return params_from_jax(_init_tree(seed, num_labels, width_mult), device)


def _to_anchor_rows(y: torch.Tensor, width: int) -> torch.Tensor:
    """(N, A*width, H, W) head output → (N, H*W*A, width), anchors in
    (row, col, anchor) order as the JAX package's NHWC reshape gives them."""
    return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, width)


def apply(params: Params, x: torch.Tensor, dtype=torch.bfloat16, int8: bool = False):
    """(N,H,W,3) or (H,W,3) float input → float32 (boxes (…,P,4), scores
    (…,P,num_labels)).  ``int8=True``: every ungrouped conv with a
    quantized weight (stem, expand and project, extras, both heads) runs
    int8 x int8 → int32; the depthwise convs stay in ``dtype``."""
    x, squeezed = ensure_batched(x, 4)
    y = x.to(dtype).permute(0, 3, 1, 2)  # NHWC → NCHW view (channels_last)
    y = conv_bn_relu6(params["stem"], y, stride=2, dtype=dtype, int8=int8)
    features: List[torch.Tensor] = []
    for i, block in enumerate(params["blocks"]):
        y = mobilenet_v2._block_apply(block, y, dtype, int8=int8)
        if i == 12:  # end of the 96-channel stage, stride 16
            features.append(y)
    features.append(y)  # stride 32, 320 channels
    for extra in params["extras"]:
        y = conv_bn_relu6(extra, y, stride=2, dtype=dtype, int8=int8)
        features.append(y)

    num_labels = params["num_labels"]
    boxes, scores = [], []
    for feat, bh, ch in zip(features, params["box_heads"], params["cls_heads"]):
        boxes.append(_to_anchor_rows(conv2d(bh, feat, dtype=dtype, int8=int8), 4))
        scores.append(_to_anchor_rows(conv2d(ch, feat, dtype=dtype, int8=int8), num_labels))
    boxes = torch.cat(boxes, dim=1).to(torch.float32)
    scores = torch.cat(scores, dim=1).to(torch.float32)
    if squeezed:
        return boxes[0], scores[0]
    return boxes, scores


# The JAX package's decode head divides by literals inside a jitted program,
# which XLA compiles into a multiply by the literal's float32 reciprocal.
_INV10 = _reciprocal(10.0, _F32)
_INV5 = _reciprocal(5.0, _F32)


def decode_topk(boxes: torch.Tensor, scores: torch.Tensor, priors, k: int = 100) -> torch.Tensor:
    """On-device SSD decode head: sigmoid scores → best non-background class
    per anchor → the ``k`` best anchors (ties to the lower index, as
    ``lax.top_k``) → prior decode.  Rows ``[x, y, w, h, class, score]``,
    geometry normalized to [0, 1]; ``priors`` is (4, P) ycenter/xcenter/h/w."""
    squeezed = boxes.dim() == 2
    if squeezed:
        boxes, scores = boxes[None], scores[None]
    if boxes.shape[-2] != priors.shape[-1]:
        raise ValueError(
            f"decode_topk: {boxes.shape[-2]} boxes vs {priors.shape[-1]} priors — priors "
            "must come from generate_priors(image_size) for the model's input size")
    s = torch.sigmoid(scores[..., 1:].to(torch.float32))
    best = s.amax(dim=-1)
    cls = (s.argmax(dim=-1) + 1).to(torch.float32)  # class 0 = background
    top_i = torch.sort(best, dim=-1, descending=True, stable=True).indices[..., :k]
    top_s = best.gather(1, top_i)
    loc = boxes.to(torch.float32).gather(1, top_i[..., None].expand(-1, -1, 4))
    pri = torch.as_tensor(priors, dtype=torch.float32, device=boxes.device).T[top_i]
    ycenter = loc[..., 0] * _INV10 * pri[..., 2] + pri[..., 0]
    xcenter = loc[..., 1] * _INV10 * pri[..., 3] + pri[..., 1]
    h = torch.exp(loc[..., 2] * _INV5) * pri[..., 2]
    w = torch.exp(loc[..., 3] * _INV5) * pri[..., 3]
    top_c = cls.gather(1, top_i)
    out = torch.stack([xcenter - w * 0.5, ycenter - h * 0.5, w, h, top_c, top_s], dim=-1)
    return out[0] if squeezed else out


def generate_priors(image_size: int = 300) -> np.ndarray:
    """Anchor grid (4, num_priors(image_size)): ycenter/xcenter/h/w rows,
    the decoder's priors-file contract; 1917 columns at 300x300."""
    grids = feature_grids(image_size)
    rows = [[], [], [], []]
    scales = np.linspace(0.2, 0.95, len(grids))
    ratios6 = [1.0, 2.0, 0.5, 3.0, 1.0 / 3.0, 1.0]
    for (grid, anchors), scale in zip(grids, scales):
        ratios = ratios6[:anchors]
        for gy in range(grid):
            for gx in range(grid):
                cy = (gy + 0.5) / grid
                cx = (gx + 0.5) / grid
                for k, r in enumerate(ratios):
                    s = scale * (1.1 if (anchors == 6 and k == 5) else 1.0)
                    rows[0].append(cy)
                    rows[1].append(cx)
                    rows[2].append(s / np.sqrt(r))
                    rows[3].append(s * np.sqrt(r))
    priors = np.asarray(rows, np.float32)
    assert priors.shape == (4, num_priors(image_size)), priors.shape
    return priors


def write_priors_file(path: str, image_size: int = 300) -> str:
    priors = generate_priors(image_size)
    with open(path, "w", encoding="utf-8") as f:
        for row in priors:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    return path


def build(num_labels: int = 91, image_size: int = 300, batch: Optional[int] = None,
          dtype=torch.bfloat16, seed: int = 0, params: Optional[Params] = None,
          fused_decode: Optional[int] = None, device="cuda", int8: bool = False) -> TorchModel:
    """A stream-ready detector.  ``fused_decode=K`` appends
    :func:`decode_topk`: the model then emits one ``(K, 6)`` detection tensor
    (the ``fused-ssd`` decoder's input) instead of raw boxes and scores.
    ``params``, when given, is a tree in the JAX package's layout (numpy
    leaves, see :func:`params_from_jax`).  ``int8=True`` routes the convs
    with quantized weights through the int8 path (pass quantized params,
    or use :func:`build_quantized`)."""
    tree = params if params is not None else _init_tree(seed, num_labels, 1.0)
    p = params_from_jax(tree, device)
    num_labels = p["num_labels"]
    lead: Tuple[int, ...] = (batch,) if batch is not None else ()
    n = num_priors(image_size)
    if fused_decode:
        priors = torch.from_numpy(generate_priors(image_size)).to(device)

        def fwd(params_, x):
            boxes, scores = apply(params_, x, dtype=dtype, int8=int8)
            return decode_topk(boxes, scores, priors, k=fused_decode)

        outs = (TensorSpec(dtype=np.float32, shape=lead + (min(fused_decode, n), 6)),)
    else:
        def fwd(params_, x):
            return apply(params_, x, dtype=dtype, int8=int8)

        outs = (TensorSpec(dtype=np.float32, shape=lead + (n, 4)),
                TensorSpec(dtype=np.float32, shape=lead + (n, num_labels)))
    return TorchModel(
        apply=fwd, params=p,
        input_spec=TensorsSpec.of(
            TensorSpec(dtype=np.float32, shape=lead + (image_size, image_size, 3))),
        output_spec=TensorsSpec(tensors=outs),
        name="ssd_mobilenet_v2", device=device,
    )


def build_quantized(num_labels: int = 91, image_size: int = 300, batch: Optional[int] = None,
                    dtype=torch.bfloat16, seed: int = 0, params: Optional[Params] = None,
                    fused_decode: Optional[int] = None, device="cuda") -> TorchModel:
    """Full-int8 detector, as the JAX package's: every ungrouped conv
    (stem, expand and project, extras, box and class heads) runs int8 x
    int8 → int32 with per-sample activation scales, its weight stored per
    output channel (:func:`~..ops.quant.quantize_model`) and prepared for
    the int8 product once, here."""
    m = quantize_model(build(num_labels, image_size, batch, dtype, seed, params,
                             fused_decode=fused_decode, device=device, int8=True))
    prepare_int8(m.params)
    return m
