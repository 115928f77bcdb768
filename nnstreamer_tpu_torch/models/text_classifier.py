"""Byte-level transformer text classifier for ``text/x-raw`` streams.

The port of the JAX package's ``models/text_classifier.py``: the
converter's null-padded uint8 text buffer is the model's input; each byte
indexes a ``(256, d_model)`` embedding table (no tokenizer on the host),
learned positions are added, the non-causal encoder (:mod:`.transformer`)
runs, and the per-token logits are mean-pooled over the non-null bytes (an
all-null frame gives zero logits).  The frame's spec is the converter's
(``media.TextSpec``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..backends.torch_backend import TorchModel
from ..spec import TensorSpec, TensorsSpec, torch_dtype
from . import transformer
from .layers import Params, ensure_batched


def init_tree(seed: int = 0, num_classes: int = 4, seq_len: int = 256, d_model: int = 128,
              n_heads: int = 4, n_layers: int = 2) -> Params:
    """Random params in the JAX package's layout: the encoder's tree with
    ``d_in == d_model``, and ``byte_embed`` and ``pos_embed``, stddev 0.02."""
    tree = transformer.init_tree(seed, d_model, n_heads, n_layers, 4 * d_model, d_model,
                                 num_classes)
    rng = np.random.default_rng([seed, 2])
    tree["byte_embed"] = rng.standard_normal((256, d_model), dtype=np.float32) * np.float32(0.02)
    tree["pos_embed"] = rng.standard_normal((seq_len, d_model), dtype=np.float32) * np.float32(0.02)
    return tree


def init_params(seed: int = 0, num_classes: int = 4, seq_len: int = 256, d_model: int = 128,
                n_heads: int = 4, n_layers: int = 2, dtype=torch.bfloat16,
                device="cuda") -> Params:
    return transformer.prepare(init_tree(seed, num_classes, seq_len, d_model, n_heads,
                                         n_layers), dtype, device)


def apply(params: Params, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(B, T) or (T,) uint8 bytes → (B, classes) / (classes,) float32
    logits."""
    dtype = torch_dtype(dtype)
    x, squeezed = ensure_batched(x, 2)
    idx = x.long()
    tok = params["byte_embed"][idx]  # (B, T, d)
    w = (idx != 0).to(dtype)[..., None]  # null padding weighs nothing
    per_token = transformer.apply(params, tok, causal=False, dtype=dtype)
    denom = w.sum(dim=-2).clamp(min=1.0)
    logits = (per_token * w).sum(dim=-2) / denom
    return (logits[0] if squeezed else logits).to(torch.float32)


def build(num_classes: int = 4, seq_len: int = 256, d_model: int = 128, n_heads: int = 4,
          n_layers: int = 2, batch: Optional[int] = None, dtype=torch.bfloat16, seed: int = 0,
          params: Optional[Params] = None, device="cuda") -> TorchModel:
    """Stream-ready model over the converter's ``text/x-raw`` output: one
    frame is one ``(size,)`` uint8 buffer."""
    dtype = torch_dtype(dtype)
    tree = params if params is not None else init_tree(seed, num_classes, seq_len, d_model,
                                                       n_heads, n_layers)
    shape = (seq_len,) if batch is None else (batch, seq_len)
    out = (num_classes,) if batch is None else (batch, num_classes)
    return TorchModel(
        apply=lambda p, x: apply(p, x, dtype=dtype),
        params=transformer.prepare(tree, dtype, device),
        input_spec=TensorsSpec.of(TensorSpec(dtype=np.uint8, shape=shape)),
        output_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=out)),
        name=f"text_transformer_{d_model}x{n_layers}", device=device,
    )
