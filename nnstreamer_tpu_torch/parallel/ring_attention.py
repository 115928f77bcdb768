"""Ring attention: attention over a sequence sharded on a mesh axis.

The port of the JAX package's ``parallel/ring_attention.py``.  The sequence
of (B, T, H, D) queries, keys and values is cut into ``n`` shards along T,
one a device of the axis.  Each shard's queries meet every K/V block in
turn: the K/V shards rotate one step around the ring (:func:`~.mesh.rotate`,
``ppermute``'s port) while each shard accumulates its output with an online
softmax in float32 (Ring Attention, Liu et al. 2023).  As in the reference
there are ``n - 1`` rotations and the last block is consumed in place, and
a row every key of which is masked gives zeros.

:func:`full_attention` is the single-device golden path; it rounds the
softmax in the compute dtype as ``jax.nn.softmax`` does, where the ring
accumulates in float32, so in bfloat16 the two differ by more than rounding
in either package.
"""

from __future__ import annotations

from typing import List, Union

import torch

from .mesh import Mesh, NamedSharding, Sharded, rotate, split


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


def _online_block(q, k, v, m, l, acc, q_pos, k_pos, scale, causal):
    """One blockwise step with streaming-softmax accumulators: q (B, Tq, H,
    D), k/v (B, Tk, H, D), m/l (B, H, Tq), acc (B, H, Tq, D), all float32;
    ``q_pos``/``k_pos`` the global positions, for the causal mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = None
    if causal:
        mask = k_pos[None, None, None, :] > q_pos[None, None, :, None]
        s = s.masked_fill(mask, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a row masked so far: exp(-inf - -inf) would be NaN, keep it at zero
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = p.masked_fill(mask, 0.0)
    corr = torch.exp(torch.where(torch.isneginf(m), m_new, m) - m_safe)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v)
    return m_new, l_new, acc_new


def _shards(x, n: int, devs) -> List[torch.Tensor]:
    return x.shards if isinstance(x, Sharded) else split(x, n, 1, devs)


def ring_attention(q: Union[torch.Tensor, Sharded], k, v, mesh: Mesh, axis: str = "sp",
                   causal: bool = False):
    """Attention over sequences sharded on ``axis`` of ``mesh``.

    q/k/v: (B, T, H, D) tensors, cut into shards along T here (T must
    divide), or :class:`~.mesh.Sharded` values already cut so.  Returns
    (B, T, H, D): a tensor on ``q``'s device for tensor inputs, else a
    :class:`~.mesh.Sharded` placed as ``q``."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    qs, ks, vs = (_shards(a, n, devs) for a in (q, k, v))
    scale = qs[0].shape[-1] ** -0.5
    state = []
    for idx, (qi, dev) in enumerate(zip(qs, devs)):
        b, t_q, h, d = qi.shape
        q_pos = idx * t_q + torch.arange(t_q, device=dev)
        state.append([qi.to(torch.float32), q_pos,
                      torch.full((b, h, t_q), float("-inf"), dtype=torch.float32, device=dev),
                      torch.zeros((b, h, t_q), dtype=torch.float32, device=dev),
                      torch.zeros((b, h, t_q, d), dtype=torch.float32, device=dev)])

    def block(i):
        for idx, st in enumerate(state):
            kb, vb = ks[idx], vs[idx]
            t_k = kb.shape[1]
            src = (idx - i) % n  # the K/V block resident here came from shard src
            k_pos = src * t_k + torch.arange(t_k, device=kb.device)
            st[2], st[3], st[4] = _online_block(st[0], kb.to(torch.float32),
                                                vb.to(torch.float32), st[2], st[3], st[4],
                                                st[1], k_pos, scale, causal)

    for i in range(n - 1):
        block(i)
        ks, vs = rotate(ks, devs), rotate(vs, devs)
    block(n - 1)  # the last shard consumed in place: no rotation after it
    outs = []
    for qi, st in zip(qs, state):
        l = torch.where(st[3] == 0.0, torch.ones_like(st[3]), st[3])  # masked rows: zeros
        outs.append((st[4] / l[..., None]).to(qi.dtype).permute(0, 2, 1, 3))
    if isinstance(q, Sharded):
        return Sharded(outs, q.sharding)
    return torch.cat([o.to(q.device) for o in outs], dim=1)


def sequence_sharding(mesh: Mesh, rank: int = 4, axis: str = "sp") -> NamedSharding:
    """The sequence dim (dim 1 of (B, T, ...) inputs) split over ``axis``."""
    spec = [None] * rank
    spec[1] = axis
    return NamedSharding(mesh, tuple(spec))
