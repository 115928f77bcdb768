"""Ulysses sequence parallelism: an all-to-all from sequence shards to
head shards and back.

The port of the JAX package's ``parallel/sequence.py`` (DeepSpeed-Ulysses,
Jacobs et al. 2023): (B, T/n, H, D) sequence shards become (B, T, H/n, D)
head shards by one :func:`~.mesh.all_to_all`, each device runs whole-
sequence attention (:func:`~.ring_attention.full_attention`) on its heads,
and a second all-to-all restores the sequence shards.  The heads must
divide over the axis.
"""

from __future__ import annotations

from typing import Union

import torch

from .mesh import Mesh, Sharded, all_to_all
from .ring_attention import _shards, full_attention


def ulysses_attention(q: Union[torch.Tensor, Sharded], k, v, mesh: Mesh, axis: str = "sp",
                      causal: bool = False):
    """Attention with (B, T, H, D) inputs and output sharded on T over
    ``axis``; tensors and :class:`~.mesh.Sharded` values as
    :func:`~.ring_attention.ring_attention` takes them."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    h = (q.shards[0] if isinstance(q, Sharded) else q).shape[2]
    if h % n != 0:
        raise ValueError(f"heads {h} not divisible by mesh axis {axis}={n}")
    # (B, T/n, H, D) -> (B, T, H/n, D): gather the sequence, scatter the heads
    qh, kh, vh = (all_to_all(_shards(a, n, devs), devs, split_axis=2, concat_axis=1)
                  for a in (q, k, v))
    outs = [full_attention(a, b, c, causal=causal) for a, b, c in zip(qh, kh, vh)]
    outs = all_to_all(outs, devs, split_axis=1, concat_axis=2)
    if isinstance(q, Sharded):
        return Sharded(outs, q.sharding)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
