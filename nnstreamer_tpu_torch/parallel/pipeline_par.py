"""Pipeline parallelism over the ``pp`` mesh axis: GPipe microbatches.

The port of the JAX package's ``parallel/pipeline_par.py``.  Stage ``i``
lives on the ``i``-th device of the axis with its slice of the
stage-stacked params; the batch is cut into ``M`` microbatches, which enter
stage 0 and move one stage a tick (:func:`~.mesh.ppermute`), so a batch
takes ``M + S - 1`` ticks (the fill and drain bubble).  The last stage
writes each finished microbatch into its output buffer, which is the
result.  The reference's SPMD program also computes every stage in the
bubble's ticks, on zeros, and throws that away; a single controller knows
which (stage, tick) pairs hold a microbatch and runs only those.

Contract: ``stage_fn(stage_params, x) -> y`` with ``y.shape == x.shape``;
``stage_params`` is a tree whose leaves carry a leading stage dim of size
S, or a list of S per-stage trees.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .mesh import Mesh, move, ppermute, tree_map


def stack_stage_params(per_stage_params: list):
    """[stage0_tree, stage1_tree, ...] → one tree with a leading stage dim
    (tensor leaves stacked as tensors, numpy leaves as numpy)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in per_stage_params])
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(list(per_stage_params))
    return np.stack([np.asarray(a) for a in per_stage_params])  # a JAX-layout tree's leaves


def stage_trees(stage_params, s: int, devs) -> list:
    """The S per-stage trees, each on its stage's device (a view of the
    stacked leaf where it is there already)."""
    if isinstance(stage_params, list) and len(stage_params) == s:
        return [tree_map(lambda a, d=d: move(a, d), p) for p, d in zip(stage_params, devs)]
    return [tree_map(lambda a, i=i, d=d: move(a[i], d), stage_params)
            for i, d in enumerate(devs)]


def gpipe_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh: Mesh,
                axis: str = "pp", microbatches: Optional[int] = None) -> torch.Tensor:
    """``x`` (leading batch dim) through the S stages of ``axis``.
    ``microbatches`` defaults to S; the batch must divide into it.  Returns
    ``x``'s shape, on ``x``'s device."""
    devs = mesh.axis_devices(axis)
    s = len(devs)
    m = microbatches or s
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    xs = x.reshape(m, b // m, *x.shape[1:])
    local = stage_trees(stage_params, s, devs)
    outbuf = None  # the last stage's buffer, on its device
    carry = [torch.zeros_like(xs[0], device=d) for d in devs]
    for t in range(m + s - 1):
        recv = ppermute(carry, devs, [(i, i + 1) for i in range(s - 1)])  # stage i → i+1
        for i in range(s):
            if 0 <= t - i < m:  # stage i holds microbatch t - i at tick t
                inp = move(xs[t], devs[0]) if i == 0 else recv[i]
                carry[i] = stage_fn(local[i], inp)
        mb = t - (s - 1)  # the last stage emits microbatch t - (S - 1)
        if mb >= 0:
            if outbuf is None:
                outbuf = torch.empty((m,) + tuple(carry[-1].shape), dtype=x.dtype,
                                     device=devs[-1])
            outbuf[mb] = carry[-1].to(outbuf.dtype)
    return move(outbuf.reshape(b, *outbuf.shape[2:]), x.device)
