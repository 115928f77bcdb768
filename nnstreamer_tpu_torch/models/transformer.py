"""Streaming transformer encoder and its KV-cache decode cell.

The port of the JAX package's ``models/transformer.py``: pre-LN blocks
(layer norm, fused QKV projection, attention, output projection; layer
norm, tanh-GELU FFN), with the same params tree, so a tree the JAX package
made (or wrote to a checkpoint) serves here through :func:`params_from_jax`.

- :func:`apply` / :func:`build`: the whole-window encoder, attention over
  the window on one device (``attn="full"``);
- :func:`decode_step` / :func:`build_decode_cell`: one autoregressive step
  against a ``(L, 2, T_max, d_model)`` K/V cache, the state that cycles
  through repo slots as the LSTM cell's (h, c) does;
- :func:`prefill`: a whole prompt in one causal pass, giving the state
  :func:`decode_step` continues from; :func:`step_slots`: the decode step
  over a batch of slots, the serving engine's tick (``serving.py``).

Every op mirrors the reference's steps in the activation dtype: the layer
norm's two-pass variance and ``rsqrt`` (``F.layer_norm`` rounds once, in
float32), the softmax's rounded exponentials, ``-inf`` masks before the
softmax, GELU's tanh form.  Weights are stored in float32 in the tree and
cast to the compute dtype once, when a model is built (the same bits as
the reference's cast at each use).  A quantized ``"w"`` leaf runs W8A8
(:func:`~nnstreamer_tpu_torch.ops.quant.matmul_int8`: the reference leaves
that product to XLA, so ``torch._int_mm`` is its port); its int8 matrix is
prepared once at build time (``"w_mat"``).

The mesh modes, as in the JAX package: ``attn="ring"`` / ``"ulysses"``
shard each block's attention over the sequence on a mesh axis
(``parallel/ring_attention.py``, ``parallel/sequence.py``);
``moe_experts > 0`` puts a switch MoE in every block's place of the dense
FFN, its experts split over ``moe_mesh`` (``parallel/moe.py``); and
:func:`build_pipelined` runs the block stack as GPipe stages over a
``pp`` axis (``parallel/pipeline_par.py``).  The reference's refusals stay:
no W8A8 for MoE blocks, no decode or prefill through them (switch capacity
is a sequence-level quantity).  A model whose mesh lies on one card is
captured as one CUDA graph a geometry, as any other; one whose mesh spans
cards runs eagerly there (``TorchModel.capturable``).  Weights are random:
:func:`init_tree` seeds numpy from an int.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..backends.torch_backend import TorchModel
from ..device import resolve_device
from ..ops.quant import QuantizedWeight, int8_weight_matrix, matmul_int8, quantize_params
from ..parallel.mesh import on_one_device, tree_map
from ..parallel.ring_attention import full_attention, softmax
from ..spec import TensorSpec, TensorsSpec, torch_dtype
from .layers import Params, ensure_batched


# -- params --------------------------------------------------------------------


def init_tree(seed: int, d_model: int = 128, n_heads: int = 8, n_layers: int = 2,
              d_ff: int = 512, d_in: int = 64, n_out: int = 16, moe_experts: int = 0) -> Params:
    """Random params in the JAX package's layout (numpy leaves): (cin, cout)
    dense kernels with stddev ``sqrt(1/cin)``, zero biases, unit layer-norm
    scales, and ``n_heads``.  ``moe_experts > 0``: each block's FFN is a
    switch MoE of that many experts (``parallel/moe.py``'s layout)."""
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by n_heads {n_heads}")
    rng = np.random.default_rng(seed)

    def dense(cin, cout):
        w = rng.standard_normal((cin, cout), dtype=np.float32) * np.float32(np.sqrt(1.0 / cin))
        return {"w": w, "b": np.zeros((cout,), np.float32)}

    def ln():
        return {"scale": np.ones((d_model,), np.float32), "bias": np.zeros((d_model,), np.float32)}

    tree: Params = {"embed": dense(d_in, d_model), "blocks": [], "ln_f": ln(),
                    "head": dense(d_model, n_out), "n_heads": n_heads}
    for _ in range(n_layers):
        blk = {"ln1": ln(), "qkv": dense(d_model, 3 * d_model),
               "proj": dense(d_model, d_model), "ln2": ln()}
        if moe_experts > 0:
            from ..parallel.moe import init_moe_tree

            blk["moe"] = init_moe_tree(rng, d_model, d_ff, moe_experts)
        else:
            blk["ff1"], blk["ff2"] = dense(d_model, d_ff), dense(d_ff, d_model)
        tree["blocks"].append(blk)
    return tree


def _tensor(a: Any, device) -> torch.Tensor:
    """A copy of a leaf on ``device``: float leaves as float32, integer
    leaves (int8 weights) in their own dtype."""
    t = a.detach() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, order="C"))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device).clone()


def params_from_jax(tree: Any, device="cuda") -> Params:
    """The port's params from a tree in the JAX package's layout: numpy (or
    tensor) leaves, ``QuantizedWeight`` leaves read by their ``.q`` /
    ``.scale``, ``n_heads`` as an int.  ``pos_embed`` and ``byte_embed``
    (ViT, the text classifier) come across as any other leaf."""
    dev = resolve_device(device)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if hasattr(node, "q") and hasattr(node, "scale"):
            return QuantizedWeight(_tensor(node.q, dev), _tensor(node.scale, dev).reshape(1, -1))
        if key == "n_heads":
            return int(np.asarray(node.cpu() if isinstance(node, torch.Tensor) else node))
        return _tensor(node, dev)

    return walk(tree)


def prepare(tree: Params, dtype=torch.float32, device="cuda", quantize: bool = False) -> Params:
    """A model's params: the tree on ``device`` (:func:`params_from_jax`),
    every ``"w"`` of ndim >= 2 made int8 first when ``quantize`` (as the
    JAX package's ``quantize_model`` does, from the float32 weights), float
    leaves cast to ``dtype`` once, and each int8 weight's ``int_mm`` matrix
    made once, beside it as ``"w_mat"``."""
    dtype = torch_dtype(dtype)
    if quantize:
        tree = quantize_params(tree)
    params = params_from_jax(tree, device)

    def cast(node):
        if isinstance(node, dict):
            out = {k: cast(v) for k, v in node.items() if k != "w_mat"}
            if isinstance(node.get("w"), QuantizedWeight):
                out["w_mat"] = int8_weight_matrix(node["w"].q)
            return out
        if isinstance(node, list):
            return [cast(v) for v in node]
        if isinstance(node, torch.Tensor) and node.is_floating_point():
            return node.to(dtype)
        return node

    return cast(params)


# The reference's words for what it refuses MoE blocks.
_MOE_REFUSED = {
    "decode_step": "decode_step does not support MoE blocks (capacity semantics are "
                   "sequence-level); use the dense-FFN encoder for decode",
    "prefill": "prefill does not support MoE blocks (capacity semantics are sequence-level "
               "relative to the FULL batch); use the dense-FFN encoder for decode",
    "build_quantized": "build_quantized does not cover MoE blocks: the expert weights (w1/w2, "
                       "expert-stacked 3-D) need expert-level scale handling and only the gate "
                       "would quantize — use the dense-FFN encoder for W8A8",
}


def _refuse_moe(params: Params, what: str) -> None:
    if any("moe" in blk for blk in params["blocks"]):
        raise NotImplementedError(_MOE_REFUSED[what])


# -- the encoder -----------------------------------------------------------------


def _proj(p: Params, x: torch.Tensor, dtype) -> torch.Tensor:
    """``x @ w + b``; an int8 ``"w"`` runs W8A8 with per-row dynamic
    activation scales."""
    w = p["w"]
    if isinstance(w, QuantizedWeight):
        return matmul_int8(x, w, dtype, w_mat=p.get("w_mat")) + p["b"].to(dtype)
    return x @ w.to(dtype) + p["b"].to(dtype)


def _layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's layer norm, step by step in ``x``'s dtype: the mean,
    the two-pass variance, ``rsqrt(var + eps)``."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def _ffn_residual(blk: Params, y: torch.Tensor, dtype, moe_mesh=None,
                  moe_axis: str = "ep") -> torch.Tensor:
    """ln2, the GELU FFN (``jax.nn.gelu``'s default: the tanh form) or the
    switch MoE, and the residual, shared by the encoder, the decode step
    and prefill."""
    z = _layernorm(blk["ln2"], y)
    if "moe" in blk:
        from ..parallel.moe import moe_ffn

        return y + moe_ffn(blk["moe"], z, mesh=moe_mesh, axis=moe_axis, dtype=dtype)
    z = F.gelu(_proj(blk["ff1"], z, dtype), approximate="tanh")
    return y + _proj(blk["ff2"], z, dtype)


ATTN_MODES = ("full", "ring", "ulysses")


def _check_attn(attn: str, mesh=None) -> None:
    if attn not in ATTN_MODES:
        raise ValueError(f"unknown attention mode {attn!r}")
    if attn != "full" and mesh is None:
        raise ValueError(f"attn={attn!r} shards the sequence over a mesh axis: pass mesh=")


def _attention(q, k, v, attn: str, mesh, axis: str, causal: bool) -> torch.Tensor:
    if attn == "ring":
        from ..parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, mesh, axis=axis, causal=causal)
    if attn == "ulysses":
        from ..parallel.sequence import ulysses_attention

        return ulysses_attention(q, k, v, mesh, axis=axis, causal=causal)
    return full_attention(q, k, v, causal=causal)


def _block_apply(blk: Params, y: torch.Tensor, h: int, causal: bool, dtype, attn: str = "full",
                 mesh=None, axis: str = "sp", moe_mesh=None, moe_axis: str = "ep"
                 ) -> torch.Tensor:
    """One pre-LN encoder block over (B, T, d)."""
    b, t, d = y.shape
    z = _layernorm(blk["ln1"], y)
    q, k, v = _proj(blk["qkv"], z, dtype).split(d, dim=-1)
    q, k, v = (a.reshape(b, t, h, d // h) for a in (q, k, v))
    o = _attention(q, k, v, attn, mesh, axis, causal).reshape(b, t, d)
    y = y + _proj(blk["proj"], o, dtype)
    return _ffn_residual(blk, y, dtype, moe_mesh, moe_axis)


def apply(params: Params, x: torch.Tensor, attn: str = "full", mesh=None, axis: str = "sp",
          causal: bool = True, dtype=torch.float32, moe_mesh=None,
          moe_axis: str = "ep") -> torch.Tensor:
    """(B, T, d_in) or (T, d_in) features → (B, T, n_out) / (T, n_out)
    float32.  ``attn="ring"`` / ``"ulysses"`` shard attention over ``axis``
    of ``mesh``; MoE blocks split their experts over ``moe_axis`` of
    ``moe_mesh`` (one device without)."""
    dtype = torch_dtype(dtype)
    _check_attn(attn, mesh)
    x, squeezed = ensure_batched(x, 3)
    h = params["n_heads"]
    y = _proj(params["embed"], x.to(dtype), dtype)
    pe = params.get("pos_embed")
    if pe is not None:  # learned positions (ViT, the text classifier)
        y = y + pe.to(dtype)
    for blk in params["blocks"]:
        y = _block_apply(blk, y, h, causal, dtype, attn, mesh, axis, moe_mesh, moe_axis)
    y = _layernorm(params["ln_f"], y)
    out = _proj(params["head"], y, dtype).to(torch.float32)
    return out[0] if squeezed else out


def place_moe(params: Params, moe_mesh, moe_axis: str = "ep") -> Params:
    """``params`` with each MoE block's experts split over ``moe_axis``
    (``parallel/moe.place_moe_params``), once, at build time."""
    if moe_mesh is None:
        return params
    from ..parallel.moe import place_moe_params

    out = dict(params)
    out["blocks"] = [dict(blk, moe=place_moe_params(blk["moe"], moe_mesh, moe_axis))
                     if "moe" in blk else blk for blk in params["blocks"]]
    return out


def build(seq_len: int = 256, d_in: int = 64, n_out: int = 16, d_model: int = 128,
          n_heads: int = 8, n_layers: int = 2, attn: str = "full", mesh=None, axis: str = "sp",
          causal: bool = True, batch: Optional[int] = None, dtype=torch.float32, seed: int = 0,
          params: Optional[Params] = None, moe_experts: int = 0, moe_mesh=None,
          moe_axis: str = "ep", quantized: bool = False, device="cuda") -> TorchModel:
    """Stream-ready encoder: one frame is one (T, d_in) window (the
    aggregator's output).  ``params``: a tree in the JAX package's layout;
    ``quantized``: W8A8 (:func:`build_quantized`); ``moe_experts``: a
    switch MoE in every block, its experts over ``moe_mesh``."""
    _check_attn(attn, mesh)
    dtype = torch_dtype(dtype)
    tree = params if params is not None else init_tree(seed, d_model, n_heads, n_layers,
                                                       4 * d_model, d_in, n_out, moe_experts)
    if quantized:
        _refuse_moe(tree, "build_quantized")
    shape: Tuple[int, ...] = (seq_len, d_in) if batch is None else (batch, seq_len, d_in)
    return TorchModel(
        apply=lambda p, x: apply(p, x, attn=attn, mesh=mesh, axis=axis, causal=causal,
                                 dtype=dtype, moe_mesh=moe_mesh, moe_axis=moe_axis),
        params=place_moe(prepare(tree, dtype, device, quantize=quantized), moe_mesh, moe_axis),
        input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=shape)),
        output_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=shape[:-1] + (n_out,))),
        name=f"transformer_{attn}_{d_model}x{n_layers}" + ("_q8" if quantized else ""),
        device=device, capturable=on_one_device(mesh, moe_mesh),
    )


def build_quantized(**kwargs) -> TorchModel:
    """W8A8 encoder: every ``"w"`` (embed, qkv, proj, FFN, head) int8 per
    output channel, activations quantized per row at run time; attention
    stays in the compute dtype.  Takes :func:`build`'s kwargs; MoE blocks
    are refused, as in the reference."""
    if kwargs.get("moe_experts", 0):
        raise NotImplementedError(_MOE_REFUSED["build_quantized"])
    return build(**kwargs, quantized=True)


def stage_stack(blocks: list, stages: int) -> Params:
    """A block list as the JAX package's stage-stacked tree: leaves of
    shape (stages, layers a stage, ...)."""
    from ..parallel.pipeline_par import stack_stage_params

    if len(blocks) % stages:
        raise ValueError(f"n_layers {len(blocks)} not divisible by {stages} stages")
    per = len(blocks) // stages
    return stack_stage_params([stack_stage_params(blocks[i * per:(i + 1) * per])
                               for i in range(stages)])


def build_pipelined(mesh, axis: str = "pp", seq_len: int = 64, d_in: int = 64, n_out: int = 16,
                    d_model: int = 128, n_heads: int = 8, n_layers: int = 4, batch: int = 8,
                    microbatches: Optional[int] = None, causal: bool = True,
                    dtype=torch.float32, seed: int = 0, params=None,
                    device="cuda") -> TorchModel:
    """The encoder with its block stack **pipelined over the ``pp`` axis**
    (GPipe, ``parallel/pipeline_par.py``): ``n_layers`` in equal stages,
    one a device of the axis; the embed and the head run where the input
    is.  The params are the JAX package's pair ``(outer, stage_stacked)``
    (given as ``params``, or a :func:`init_tree` tree's blocks stacked
    here); the same function as the sequential :func:`apply`."""
    from ..parallel.pipeline_par import gpipe_apply, stage_trees

    s = mesh.shape[axis]
    if n_layers % s:
        raise ValueError(f"n_layers {n_layers} not divisible by {s} stages")
    dtype = torch_dtype(dtype)
    if params is None:
        params = init_tree(seed, d_model, n_heads, n_layers, 4 * d_model, d_in, n_out)
    if isinstance(params, dict):
        outer = {k: v for k, v in params.items() if k != "blocks"}
        params = (outer, stage_stack(params["blocks"], s))
    outer, stacked = prepare(list(params), dtype, device)
    per_stage = n_layers // s
    h = outer["n_heads"]
    stages = stage_trees(stacked, s, mesh.axis_devices(axis))  # each stage's on its device

    def stage_fn(stage_params, x):
        for j in range(per_stage):
            x = _block_apply(tree_map(lambda a: a[j], stage_params), x, h, causal, dtype)
        return x

    def pipelined_apply(p, x):
        outer_p, staged = p
        y = _proj(outer_p["embed"], x.to(dtype), dtype)
        y = gpipe_apply(stage_fn, staged, y, mesh, axis=axis, microbatches=microbatches)
        y = _layernorm(outer_p["ln_f"], y)
        return _proj(outer_p["head"], y, dtype).to(torch.float32)

    return TorchModel(
        apply=pipelined_apply,
        params=[outer, stages],
        input_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(batch, seq_len, d_in))),
        output_spec=TensorsSpec.of(TensorSpec(dtype=np.float32, shape=(batch, seq_len, n_out))),
        name=f"transformer_pp{s}_{d_model}x{n_layers}",
        device=device, capturable=on_one_device(mesh),
    )


# -- decode ------------------------------------------------------------------------


def _check_decode(params: Params, window: bool, what: str) -> None:
    _refuse_moe(params, what)
    if window and params.get("pos_embed") is not None:
        raise ValueError("window=True needs pos_embed-free params: absolute learned "
                         "positions cannot wrap a ring cache")


def step_slots(params: Params, x: torch.Tensor, cache: torch.Tensor, pos: torch.Tensor,
               dtype=torch.float32, window: bool = False, gate: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step over S slots at once, **in place**: ``x`` (S, d_in),
    ``cache`` (S, L, 2, T_max, d_model), ``pos`` (S, 1) int32.  Each slot's
    K and V go to its own write position by device-side indexing (no host
    read: the step can be captured in a CUDA graph).  ``gate`` (S,) bool:
    a slot whose gate is off keeps its cache and position (its old K/V
    are written back) and its output is to be ignored.

    Returns ``(y (S, n_out) float32, pos')``; ``cache`` holds the new
    state.  Each slot computes exactly :func:`decode_step`'s function:
    no reduction crosses the slot axis."""
    dtype = torch_dtype(dtype)
    h = params["n_heads"]
    n, t_max = cache.shape[0], cache.shape[-2]
    dev = x.device
    p_idx = pos[:, 0].long()
    # the reference's dynamic_update_slice clamps a write past the end to
    # the last row (its output is NaN then); the ring writes at pos % T_max
    slot = p_idx % t_max if window else p_idx.clamp(max=t_max - 1)
    y = _proj(params["embed"], x.to(dtype), dtype)  # (S, d)
    pe = params.get("pos_embed")
    if pe is not None:
        y = y + pe[p_idx.clamp(max=pe.shape[0] - 1)].to(dtype)
    d = y.shape[-1]
    idx = torch.arange(t_max, device=dev)
    if window:
        # slot s holds token p - ((p - s) mod T_max): live iff that token exists
        live = torch.remainder(p_idx[:, None] - idx[None, :], t_max) <= p_idx[:, None]
    else:
        live = idx[None, :] <= p_idx[:, None]
    dead = ~live[:, None, None, :]  # (S, 1, 1, T)
    rows = torch.arange(n, device=dev)
    for li, blk in enumerate(params["blocks"]):
        z = _layernorm(blk["ln1"], y)
        q, k, v = _proj(blk["qkv"], z, dtype).split(d, dim=-1)  # (S, d) each
        for j, new in ((0, k), (1, v)):
            new = new.to(cache.dtype)
            if gate is not None:
                new = torch.where(gate[:, None], new, cache[rows, li, j, slot])
            cache[rows, li, j, slot] = new
        ck = cache[:, li, 0].to(dtype).reshape(n, t_max, h, d // h)
        cv = cache[:, li, 1].to(dtype).reshape(n, t_max, h, d // h)
        s = torch.einsum("nqhd,nkhd->nhqk", q.reshape(n, 1, h, d // h), ck) * (d // h) ** -0.5
        w = softmax(s.masked_fill(dead, float("-inf")))
        o = torch.einsum("nhqk,nkhd->nqhd", w, cv).reshape(n, d)
        y = y + _proj(blk["proj"], o, dtype)
        y = _ffn_residual(blk, y, dtype)
    y = _layernorm(params["ln_f"], y)
    out = _proj(params["head"], y, dtype).to(torch.float32)
    nxt = pos + 1
    if window:
        # the ring runs forever: keep pos in [0, 2 T_max) (slot ≡ pos mod T_max)
        nxt = torch.where(nxt >= 2 * t_max, nxt - t_max, nxt)
    else:
        # past the capacity the output saturates to NaN, loudly wrong
        out = torch.where((p_idx < t_max)[:, None], out, torch.full_like(out, float("nan")))
    if gate is not None:
        nxt = torch.where(gate[:, None], nxt, pos)
    return out, nxt


def decode_step(params: Params, x_t: torch.Tensor, cache: torch.Tensor, pos: torch.Tensor,
                dtype=torch.float32, window: bool = False):
    """One autoregressive step of one stream: ``x_t`` (d_in,), ``cache``
    (L, 2, T_max, d_model), ``pos`` (1,) int32 → ``(y_t (n_out,), cache',
    pos')``, the inputs untouched.

    ``window=False``: a step past ``T_max`` gives NaN.  ``window=True``:
    the cache is a ring (token ``a`` at slot ``a % T_max``), attention sees
    the last ``T_max`` tokens and the stream runs forever."""
    _check_decode(params, window, "decode_step")
    new = cache[None].clone()
    y, nxt = step_slots(params, x_t[None], new, pos[None], dtype=dtype, window=window)
    return y[0], new[0], nxt[0]


def init_decode_cache(n_layers: int, d_model: int, t_max: int, dtype=torch.float32,
                      device="cuda") -> torch.Tensor:
    """Zeroed K/V cache for :func:`decode_step`."""
    return torch.zeros((n_layers, 2, t_max, d_model), dtype=torch_dtype(dtype),
                       device=resolve_device(device))


def prefill(params: Params, xs: torch.Tensor, t_max: int, n_valid=None, dtype=torch.float32):
    """A whole ``(T, d_in)`` prompt in one causal pass → ``(y_last (n_out,),
    cache (L, 2, T_max, d_model), pos (1,))``, the state :func:`decode_step`
    continues from, as if it had stepped over the prompt.

    ``n_valid`` (an int or an int32 tensor, default T): the prompt's real
    length, the rest padding to a length bucket.  Padded rows are masked
    out of attention and zeroed in the cache, and ``y_last`` and ``pos``
    come from the real length, so the bucket is invisible to the
    continuation.  A tensor ``n_valid`` is never read on the host."""
    dtype = torch_dtype(dtype)
    _refuse_moe(params, "prefill")
    t = xs.shape[0]
    if t > t_max:
        raise ValueError(f"prompt length {t} exceeds cache t_max {t_max}")
    dev = xs.device
    n_valid = torch.as_tensor(t if n_valid is None else n_valid, dtype=torch.int32, device=dev)
    h = params["n_heads"]
    y = _proj(params["embed"], xs.to(dtype), dtype)  # (T, d)
    pe = params.get("pos_embed")
    if pe is not None:
        y = y + pe[:t].to(dtype)
    d = y.shape[-1]
    tok = torch.arange(t, device=dev)
    valid = tok < n_valid
    # causal (key <= query) and valid keys only
    masked = ~((tok[:, None] >= tok[None, :]) & valid[None, :])[None]
    pad = torch.zeros((t_max - t, d), dtype=dtype, device=dev)
    layers = []
    for blk in params["blocks"]:
        z = _layernorm(blk["ln1"], y)
        q, k, v = _proj(blk["qkv"], z, dtype).split(d, dim=-1)  # (T, d) each
        zero = torch.zeros((), dtype=dtype, device=dev)
        layers.append(torch.stack([torch.cat([torch.where(valid[:, None], a, zero), pad])
                                   for a in (k, v)]))
        s = torch.einsum("qhd,khd->hqk", q.reshape(t, h, d // h),
                         k.reshape(t, h, d // h)) * (d // h) ** -0.5
        w = softmax(s.masked_fill(masked, float("-inf")))
        o = torch.einsum("hqk,khd->qhd", w, v.reshape(t, h, d // h)).reshape(t, d)
        y = y + _proj(blk["proj"], o, dtype)
        y = _ffn_residual(blk, y, dtype)
    y = _layernorm(params["ln_f"], y)
    out = _proj(params["head"], y, dtype).to(torch.float32)  # (T, n_out)
    y_last = out.index_select(0, (n_valid - 1).reshape(1).long())[0]
    return y_last, torch.stack(layers), n_valid.reshape(1)


def build_decode_cell(t_max: int = 128, d_in: int = 64, n_out: int = 16, d_model: int = 128,
                      n_heads: int = 8, n_layers: int = 2, dtype=torch.float32, seed: int = 0,
                      params: Optional[Params] = None, window: bool = False,
                      device="cuda") -> TorchModel:
    """Stream filter: ``(x_t, cache, pos)`` → ``(y_t, cache', pos')``, the
    cache and position cycling through repo slots like the LSTM cell's
    (h, c).  ``window=True``: ring cache, the stream runs forever."""
    dtype = torch_dtype(dtype)
    tree = params if params is not None else init_tree(seed, d_model, n_heads, n_layers,
                                                       4 * d_model, d_in, n_out)
    cache = TensorSpec(dtype=np.float32, shape=(n_layers, 2, t_max, d_model))
    pos = TensorSpec(dtype=np.int32, shape=(1,))
    return TorchModel(
        apply=lambda p, x_t, c, ps: decode_step(p, x_t, c, ps, dtype=dtype, window=window),
        params=prepare(tree, dtype, device),
        input_spec=TensorsSpec(tensors=(TensorSpec(dtype=np.float32, shape=(d_in,)), cache, pos)),
        output_spec=TensorsSpec(tensors=(TensorSpec(dtype=np.float32, shape=(n_out,)), cache,
                                         pos)),
        name=f"transformer_decode_{d_model}x{n_layers}" + ("_win" if window else ""),
        device=device,
    )
