"""Detect → crop → classify as one function, captured as one CUDA graph.

The port of the JAX package's ``models/cascade.py``, the reference
ecosystem's flagship cascade (SSD detector → box decode → a crop per
detection → a classifier) as one program:

- the detector and its top-k decode (:func:`ssd_mobilenet.decode_topk`)
  stay on the card;
- each detection's crop is a resample with no gather
  (:func:`crop_and_resize`): the scale and translation come from the box
  tensor, the output shape is fixed, so the whole cascade is one graph;
- the classifier runs once over the K crops of a frame, and only the
  ``(K, 6)`` detections and ``(K, classes)`` logits leave the card.

A rank-4 input ``(N, H, W, 3)`` runs the cascade over N frames as one
batch: one detector call, N·K crops and one classifier call.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..backends.torch_backend import TorchModel
from ..device import resolve_device
from ..spec import TensorSpec, TensorsSpec
from . import mobilenet_v2, ssd_mobilenet

_EPS32 = float(np.finfo(np.float32).eps)


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """``jax.image.scale_and_translate``'s weights for its ``"linear"``
    method with ``antialias=True`` (``jax/_src/image/scale.py``'s
    ``compute_weight_mat``), for each of a batch of scales and translations
    (shape ``B``): ``(B, in_size, out_size)`` float32, in the same order of
    operations.  Downsampling widens the triangle by ``1/scale``; a column's
    weights are normalized by their sum, zeroed where the sum is at most
    1000·eps or the sample lies outside ``[-0.5, in_size - 0.5]``."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = ((o + 0.5) * inv_scale[..., None]
                - (translation * inv_scale)[..., None] - 0.5)           # (B, out)
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample_f[..., None, :] - i[:, None]).abs() / kernel_scale[..., None, None]
    weights = torch.clamp_min(1.0 - x, 0.0)                             # the triangle
    total = weights.sum(dim=-2, keepdim=True)
    safe = torch.where(total != 0, total, torch.ones_like(total))
    weights = torch.where(total.abs() > 1000.0 * _EPS32, weights / safe,
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[..., None, :], weights, torch.zeros_like(weights))


def crop_and_resize(image: torch.Tensor, boxes_xywh: torch.Tensor, crop_size: int):
    """Resample regions of ``(H, W, C)`` (or ``(N, H, W, C)``) into
    ``(K, crop_size, crop_size, C)`` (or ``(N, K, …)``) float32.

    ``boxes_xywh``: ``(K, 4)`` (or ``(N, K, 4)``) ``[x, y, w, h]``
    normalized to [0, 1] image space, the fused SSD decode's layout.  Boxes
    are clamped to the image and floored at 1e-3 extent, so a degenerate
    detection resamples a thin sliver instead of dividing by zero.  The
    clamps are element-wise tensor ops (nothing is read to the host), so
    the function can be captured in a CUDA graph; the two weight matrices
    a box are contracted with the image by ``torch.einsum``.
    """
    squeezed = image.dim() == 3
    if squeezed:
        image, boxes_xywh = image[None], boxes_xywh[None]
    h_px, w_px = image.shape[1], image.shape[2]
    cs = crop_size
    b = boxes_xywh.to(torch.float32)
    x = b[..., 0].clamp(0.0, 1.0)
    y = b[..., 1].clamp(0.0, 1.0)
    w = torch.minimum(torch.clamp_min(b[..., 2], 1e-3), 1.0 - x + 1e-3)
    h = torch.minimum(torch.clamp_min(b[..., 3], 1e-3), 1.0 - y + 1e-3)
    # output pixel o samples the input at start_px + (o+0.5)*extent_px/cs:
    # scale_and_translate's inverse map is (o + 0.5 - t)/s - 0.5, so
    # s = cs/extent_px and t = -start_px * s
    sy = cs / (h * h_px)
    sx = cs / (w * w_px)
    n, k = b.shape[0], b.shape[1]
    wy = _weight_mat(h_px, cs, sy.reshape(-1), (-(y * h_px) * sy).reshape(-1))
    wx = _weight_mat(w_px, cs, sx.reshape(-1), (-(x * w_px) * sx).reshape(-1))
    wy = wy.reshape(n, k, h_px, cs)
    wx = wx.reshape(n, k, w_px, cs)
    rows = torch.einsum("nkhi,nhwc->nkiwc", wy, image.to(torch.float32))
    out = torch.einsum("nkiwc,nkwj->nkijc", rows, wx)
    return out[0] if squeezed else out


def params_from_jax(tree: Any, device="cuda"):
    """The cascade's params from the JAX package's ``{"det": ..., "cls": ...}``
    tree, whose leaves the caller has turned into numpy arrays."""
    return {"det": ssd_mobilenet.params_from_jax(tree["det"], device),
            "cls": mobilenet_v2.params_from_jax(tree["cls"], device)}


def build_detect_classify(num_labels: int = 91, det_size: int = 300, k: int = 8,
                          crop_size: int = 96, num_classes: int = 1001,
                          width_mult: float = 1.0, dtype=torch.bfloat16, seed: int = 0,
                          det_params=None, cls_params=None, params=None,
                          device="cuda") -> TorchModel:
    """The cascade as one model for the streaming filter.

    Input: ``(det_size, det_size, 3)`` float32, normalized upstream (the
    transform folds into the same capture), or a batch ``(N, det_size,
    det_size, 3)``.  Outputs: detections ``(k, 6)`` and each detection's
    classifier logits ``(k, num_classes)`` float32 (``(N, k, …)`` for a
    batch).  ``det_params`` / ``cls_params`` (or ``params``, a
    ``{"det", "cls"}`` tree, as a checkpoint holds it) are trees in the JAX
    package's layout; by default the detector (width 1.0) is drawn from
    ``seed`` and the classifier from ``seed + 1``.
    """
    dev = resolve_device(device)
    if params is not None:
        det_params, cls_params = params["det"], params["cls"]
    if det_params is None:
        det_params = ssd_mobilenet._init_tree(seed, num_labels, 1.0)
    if cls_params is None:
        cls_params = mobilenet_v2.init_tree(seed + 1, num_classes, width_mult)
    p = params_from_jax({"det": det_params, "cls": cls_params}, dev)
    priors = torch.from_numpy(ssd_mobilenet.generate_priors(det_size)).to(dev)

    def fwd(p_, x):
        if x.dim() not in (3, 4):
            raise ValueError(f"cascade expects (H, W, 3) or (N, H, W, 3), got rank {x.dim()}")
        boxes, scores = ssd_mobilenet.apply(p_["det"], x, dtype=dtype)
        dets = ssd_mobilenet.decode_topk(boxes, scores, priors, k=k)
        crops = crop_and_resize(x, dets[..., :4], crop_size)
        logits = mobilenet_v2.apply(p_["cls"], crops.reshape(-1, crop_size, crop_size, 3),
                                    dtype=dtype)
        return dets, logits.to(torch.float32).reshape(dets.shape[:-1] + (num_classes,))

    kk = min(k, ssd_mobilenet.num_priors(det_size))
    return TorchModel(
        apply=fwd, params=p,
        input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(det_size, det_size, 3))),
        output_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(kk, 6)),
                                   TensorSpec(dtype=np.float32, shape=(kk, num_classes))),
        name=f"cascade_ssd_mobilenet_k{k}", device=dev,
    )
