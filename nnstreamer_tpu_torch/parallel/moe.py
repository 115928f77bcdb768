"""Switch mixture-of-experts FFN with expert parallelism (the ``ep`` axis).

The port of the JAX package's ``parallel/moe.py``: top-1 gating and
capacity-bounded dispatch, all static shapes (the Mesh-TensorFlow / Switch
Transformer formulation, Fedus et al. 2021):

- the gate gives each token's expert logits; routing (:func:`route`) picks
  the argmax expert and the token's position in that expert's buffer by a
  cumulative sum, in int32 whatever the compute dtype (in bfloat16 a sum
  above 256 rounds, which would put two tokens in one slot);
- dispatch is the dense ``(tokens, experts, capacity)`` one-hot mask; a
  token past its expert's capacity falls out of it and comes back as zeros
  (the caller's residual carries it);
- the experts' FFN runs on ``(experts, capacity, d)``; with a mesh the
  expert dim is split over ``axis`` (:func:`~.mesh.split`), each device
  computes its experts with its own weights (:func:`place_moe_params`),
  and the outputs are gathered back, where the JAX package leaves the two
  all-to-alls to XLA;
- combine is the gate-weighted inverse of dispatch.

The dispatch and combine products are the reference's einsums, which the
JAX package leaves to XLA too.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quant import maybe_dequantize
from .mesh import Mesh, NamedSharding, Sharded, move, split
from .ring_attention import softmax

_recording: Optional[List[dict]] = None


def init_moe_tree(rng: np.random.Generator, d_model: int, d_ff: int, n_experts: int) -> dict:
    """Random MoE params in the JAX package's layout (numpy leaves): the
    gate a (d_model, experts) dense with stddev ``sqrt(1/d_model)``, the
    expert-stacked FFN at He scale, zero biases."""
    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    return {"gate": {"w": normal((d_model, n_experts), np.sqrt(1.0 / d_model)),
                     "b": np.zeros((n_experts,), np.float32)},
            "w1": normal((n_experts, d_model, d_ff), np.sqrt(2.0 / d_model)),
            "b1": np.zeros((n_experts, d_ff), np.float32),
            "w2": normal((n_experts, d_ff, d_model), np.sqrt(2.0 / d_ff)),
            "b2": np.zeros((n_experts, d_model), np.float32)}


@contextlib.contextmanager
def record_routes():
    """Collect each :func:`moe_ffn` call's routing (:func:`route`'s dict)
    into the yielded list, in call order: what an eager forward dropped."""
    global _recording
    prev, _recording = _recording, []
    try:
        yield _recording
    finally:
        _recording = prev


def _n_experts(params: dict) -> int:
    w1 = params["w1"]
    return sum(s.shape[0] for s in w1.shards) if isinstance(w1, Sharded) else w1.shape[0]


def route(params: dict, xt: torch.Tensor, capacity_factor: float = 2.0,
          dtype=torch.float32) -> dict:
    """Top-1 routing of (tokens, d) features: ``expert`` (t,) int64, the
    gate weight ``gate`` (t,), each token's slot ``pos`` (t,) int32 in its
    expert's buffer, ``keep`` (t,) bool (False past ``cap``) and ``cap``."""
    t = xt.shape[0]
    e = _n_experts(params)
    cap = max(1, int(np.ceil(t * capacity_factor / e)))
    gate = params["gate"]
    logits = xt @ maybe_dequantize(gate["w"], dtype) + gate["b"].to(dtype)
    probs = softmax(logits)  # (t, e), rounded in dtype as jax.nn.softmax
    expert = probs.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
    gate_w = probs.amax(dim=-1)
    onehot = (expert[:, None] == torch.arange(e, device=xt.device)).to(torch.int32)  # (t, e)
    pos = (torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot) * onehot
    pos_idx = pos.sum(dim=-1, dtype=torch.int32)  # (t,)
    return dict(expert=expert, gate=gate_w, pos=pos_idx, keep=pos_idx < cap, cap=cap,
                onehot=onehot)


def _expert_ffn(x, w1, b1, w2, b2, dtype):
    """The experts' GELU FFN on their (e, cap, d) buffers."""
    h = F.gelu(torch.einsum("ecd,edf->ecf", x, w1.to(dtype)) + b1.to(dtype)[:, None, :],
               approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, w2.to(dtype)) + b2.to(dtype)[:, None, :]


def _expert_shards(w, n: int, devs) -> List[torch.Tensor]:
    """An expert-stacked weight as ``n`` shards on ``devs``: its placed
    shards where they match, else cut here."""
    if isinstance(w, Sharded):
        if len(w.shards) == n and all(s.device == torch.device(d)
                                      for s, d in zip(w.shards, devs)):
            return w.shards
        w = w.gather()
    return split(w, n, 0, devs)


def moe_ffn(params: dict, x: torch.Tensor, mesh: Optional[Mesh] = None, axis: str = "ep",
            capacity_factor: float = 2.0, dtype=torch.float32) -> torch.Tensor:
    """Switch top-1 MoE over the trailing feature dim: (..., d_model) →
    the same shape.  With ``mesh`` the experts split over ``axis`` (the
    weights placed there by :func:`place_moe_params`, or cut here)."""
    orig = x.shape
    d = orig[-1]
    xt = x.reshape(-1, d).to(dtype)
    r = route(params, xt, capacity_factor, dtype)
    if _recording is not None:
        _recording.append(r)
    cap = r["cap"]
    keep = r["keep"].to(dtype)
    slot = (r["pos"][:, None] == torch.arange(cap, device=xt.device)).to(dtype)  # (t, cap)
    dispatch = r["onehot"].to(dtype)[:, :, None] * slot[:, None, :] * keep[:, None, None]
    expert_in = torch.einsum("tec,td->ecd", dispatch, xt)  # (e, cap, d)
    names = ("w1", "b1", "w2", "b2")
    if mesh is None:
        w = [params[k].gather(xt.device) if isinstance(params[k], Sharded) else params[k]
             for k in names]
        expert_out = _expert_ffn(expert_in, *w, dtype=dtype)
    else:
        devs = mesh.axis_devices(axis)
        n = len(devs)
        w = [_expert_shards(params[k], n, devs) for k in names]
        ins = split(expert_in, n, 0, devs)
        outs = [_expert_ffn(ins[i], *(w[j][i] for j in range(4)), dtype=dtype)
                for i in range(n)]
        expert_out = torch.cat([move(o, xt.device) for o in outs], dim=0)
    combine = dispatch * r["gate"][:, None, None]
    out = torch.einsum("tec,ecd->td", combine, expert_out)
    return out.reshape(orig).to(x.dtype)


def place_moe_params(params: dict, mesh: Mesh, axis: str = "ep") -> dict:
    """The expert-stacked weights split over ``axis`` (each device its
    experts), once; the gate stays where the tokens are, since every token
    routes where it is."""
    sharding = NamedSharding(mesh, (axis,))
    out = {"gate": params["gate"]}
    for k in ("w1", "b1", "w2", "b2"):
        out[k] = sharding.place(params[k])
    return out
