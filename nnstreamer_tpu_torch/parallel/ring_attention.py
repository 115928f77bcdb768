"""Single-device attention, the golden path of the JAX package's
``parallel/ring_attention.py``.

Only :func:`full_attention` is ported.  ``ring_attention`` (the sequence
sharded over a mesh axis, K/V rotated around the ring) and
``ulysses_attention`` need a mesh: ROADMAP item 13.
"""

from __future__ import annotations

import torch


def softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, step by step in ``s``'s dtype:
    ``exp(s - max)`` rounded, its sum (accumulated in float32, as ``jnp.sum``
    accumulates bfloat16) rounded, then the quotient.  ``torch.softmax`` on
    bfloat16 rounds once at the end, which the bfloat16 parity tests would
    see."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """``softmax(q kᵀ / sqrt(D)) v`` over (B, T, H, D) tensors, each query
    row masked past its own position when ``causal`` (``-inf`` before the
    softmax)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.arange(tk, device=s.device)[None, :] > torch.arange(tq, device=s.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", softmax(s), v)
