"""Vision Transformer classifier on the streaming transformer encoder.

The port of the JAX package's ``models/vit.py``: non-overlapping patches
become the token stream (:func:`patchify`, a reshape and one transpose),
the encoder (:mod:`.transformer`) runs over them non-causally with learned
positions, and the classifier is the head applied per token, then averaged
over the tokens (no class token; for a linear head this equals pooling
before the head).  ``attn="ring"`` / ``"ulysses"`` with a ``mesh`` shard
the patch tokens over its ``axis`` (sequence parallelism for large
images).  ViT-B/16 is ``build(d_model=768, n_heads=12, n_layers=12)`` at
``image_size=224, patch=16`` (Dosovitskiy et al. 2020, Table 1).  Weights are random, seeded with numpy; :func:`build` also takes
the JAX package's tree (``params=``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..backends.torch_backend import TorchModel
from ..parallel.mesh import on_one_device
from ..spec import TensorSpec, TensorsSpec, torch_dtype
from . import transformer
from .layers import Params


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(..., H, W, C) → (..., H/p * W/p, p*p*C) tokens, each patch's pixels
    row by row (the reference's ``moveaxis(-3, -4)`` order)."""
    h, w, c = x.shape[-3], x.shape[-2], x.shape[-1]
    if h % patch or w % patch:
        raise ValueError(f"image {h}x{w} not divisible by patch {patch}")
    gh, gw = h // patch, w // patch
    lead = tuple(x.shape[:-3])
    y = x.reshape(*lead, gh, patch, gw, patch, c).movedim(-3, -4)
    return y.reshape(*lead, gh * gw, patch * patch * c)


def init_tree(seed: int = 0, num_classes: int = 1000, image_size: int = 224, patch: int = 16,
              d_model: int = 192, n_heads: int = 3, n_layers: int = 6) -> Params:
    """Random params in the JAX package's layout: the encoder's tree
    (``d_in = patch * patch * 3``) and ``pos_embed`` (tokens, d_model),
    stddev 0.02."""
    tree = transformer.init_tree(seed, d_model, n_heads, n_layers, 4 * d_model,
                                 patch * patch * 3, num_classes)
    rng = np.random.default_rng([seed, 1])
    tokens = (image_size // patch) ** 2
    tree["pos_embed"] = rng.standard_normal((tokens, d_model), dtype=np.float32) * np.float32(0.02)
    return tree


def forward(params: Params, x: torch.Tensor, patch: int, dtype, attn: str = "full", mesh=None,
            axis: str = "sp") -> torch.Tensor:
    """(H, W, 3) or (N, H, W, 3) float → (classes,) / (N, classes) float32
    logits: the per-token logits' mean."""
    toks = patchify(x.to(dtype), patch)
    per_token = transformer.apply(params, toks, attn=attn, mesh=mesh, axis=axis, causal=False,
                                  dtype=dtype)
    return per_token.mean(dim=-2)


def build(num_classes: int = 1000, image_size: int = 224, patch: int = 16, d_model: int = 192,
          n_heads: int = 3, n_layers: int = 6, attn: str = "full", mesh=None, axis: str = "sp",
          batch: Optional[int] = None, dtype=torch.bfloat16, seed: int = 0,
          params: Optional[Params] = None, quantized: bool = False,
          device="cuda") -> TorchModel:
    """Stream-ready ViT: one frame is one (H, W, 3) image, normalized
    upstream.  ``dtype`` may be a name (``custom=dtype=bfloat16``)."""
    if image_size % patch:
        raise ValueError(f"image_size {image_size} not divisible by patch {patch}")
    transformer._check_attn(attn, mesh)
    dtype = torch_dtype(dtype)
    tree = params if params is not None else init_tree(seed, num_classes, image_size, patch,
                                                       d_model, n_heads, n_layers)
    shape: Tuple[int, ...] = (image_size, image_size, 3)
    out: Tuple[int, ...] = (num_classes,)
    if batch is not None:
        shape, out = (batch,) + shape, (batch,) + out
    return TorchModel(
        apply=lambda p, x: forward(p, x, patch, dtype, attn, mesh, axis),
        params=transformer.prepare(tree, dtype, device, quantize=quantized),
        input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=shape)),
        output_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=out)),
        name=f"vit_{attn}_p{patch}_{d_model}x{n_layers}" + ("_q8" if quantized else ""),
        device=device, capturable=on_one_device(mesh),
    )


def build_quantized(**kwargs) -> TorchModel:
    """W8A8 ViT: every trunk matmul int8 x int8 → int32 with per-token
    scales (:func:`.transformer.build_quantized`).  Takes :func:`build`'s
    kwargs."""
    return build(**kwargs, quantized=True)


def flops_per_frame(image_size: int = 224, patch: int = 16, d_model: int = 768,
                    n_layers: int = 12, num_classes: int = 1000) -> int:
    """Multiply-adds x 2 of one frame, from the shapes: the patch embed, per
    layer the QKV, output and FFN products (24 T d²) and attention's two
    (4 T² d), and the head over every token."""
    t = (image_size // patch) ** 2
    d_in = patch * patch * 3
    layer = 24 * t * d_model * d_model + 4 * t * t * d_model
    return 2 * t * d_in * d_model + n_layers * layer + 2 * t * d_model * num_classes
