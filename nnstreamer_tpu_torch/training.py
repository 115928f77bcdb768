"""Streaming training: one update step a frame, for ``tensor_trainer``.

The port of the JAX package's ``training.py``.  There, ``make_train_step``
closes a model, a loss and an optax optimizer into ONE jitted XLA program
(value_and_grad and the update), with the old params and optimizer state
donated.  Here:

- ``make_train_step`` closes the same three into a step that, on the card,
  is captured as **one CUDA graph per geometry** (forward, backward and the
  update; ``backends/torch_backend.capture_calls``, the backend's side
  stream warm-up included).  The float parameters, the optimizer state and
  its step counter are static device tensors the graph updates in place:
  the counterpart of donation, constant device memory over a long stream.
  A replay copies the frame into the graph's static inputs and returns a
  clone of its loss, with no host synchronization.  The capture's warm-up
  calls would train (three extra updates), so the state is snapshotted
  before them and put back after the capture.  The captured graph's memory
  goes on the cost registry for the deep-profiling lane's ledger
  (``obs/profiler.hbm_ledger``) while the step lives.  On the CPU, or
  without donation, the step runs eagerly.
- The optimizers (:func:`make_optimizer`) are written as plain tensor
  functions over a list of parameters, not as ``torch.optim``: they have to
  reproduce optax's semantics, which differ from PyTorch's defaults
  (``adamw``'s weight decay 1e-4 added to the update, ``rmsprop``'s decay
  0.9 with ``eps`` inside the square root and a first scale of 0, Adam's
  ``eps`` outside the root and ``eps_root``), to keep optax's state layout,
  so that a trainer checkpoint crosses between the two packages, and to
  update in place inside a captured graph.  Each update follows optax's
  arithmetic step for step (``update_moment``, ``bias_correction``,
  ``scale_by_learning_rate``, ``apply_updates``).
- The leaves of a params tree split three ways, as the JAX package splits
  them: float tensors get gradients; integer tensors and Python statics
  (a conv's stride, a residual flag) ride along untouched.  Leaves are
  ordered as ``jax.tree_util`` orders them (dict keys sorted, ``None`` no
  leaf), so the optimizer state lines up leaf for leaf with optax's.

Not ported: data parallelism over several cards (``devices`` > 1 of the
trainer), ROADMAP item 13b.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from .obs.launch_gate import launching

LOSSES: Dict[str, Callable] = {}


def _register(name):
    def deco(fn):
        LOSSES[name] = fn
        return fn

    return deco


@_register("softmax_ce")
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy in float32; integer labels ``(B,)`` or
    one-hot ``(B, C)``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    if labels.dim() == logits.dim() - 1:
        picked = logp.gather(-1, labels[..., None].to(torch.int64))[..., 0]
    else:
        picked = (logp * labels.to(torch.float32)).sum(dim=-1)
    return -picked.mean()


@_register("mse")
def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred.to(torch.float32) - target.to(torch.float32)
    return (d * d).mean()


# -- the optimizers -----------------------------------------------------------
#
# Each takes the list of float parameters.  ``init(params)`` gives the state
# in optax's layout (a NamedTuple per chained transform, as a tuple: an
# EmptyState is ``()``); ``update(grads, state, params)`` applies one step to
# the parameters and the state in place.  Python floats enter the arithmetic
# as optax's weak-typed scalars do: rounded to the tensor's dtype.

_INT32_MAX = 2 ** 31 - 1


def _step_count(count: torch.Tensor) -> None:
    """optax's ``safe_increment``, in place: +1 up to the int32 maximum."""
    count.copy_(torch.where(count < _INT32_MAX, count + 1, count))


def _bias_correction(moment: torch.Tensor, decay: float, count: torch.Tensor) -> torch.Tensor:
    """``moment / (1 - decay ** count)``, the power taken in float32 (a fill,
    not a host copy: this runs inside a graph capture)."""
    decay_t = torch.full((), decay, dtype=torch.float32, device=count.device)
    return moment / (1 - decay_t ** count.to(torch.float32)).to(moment.dtype)


class Optimizer:
    """An optax transformation chain as in-place tensor updates."""

    def __init__(self, name: str, lr: float, **kw):
        self.name = name
        self.lr = float(lr)
        self.kw = kw

    def init(self, params: List[torch.Tensor]):
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        kw = self.kw
        if self.name in ("adam", "adamw"):
            count = torch.zeros((), dtype=torch.int32,
                                device=params[0].device if params else "cpu")
            adam = (count, zeros(), zeros())
            return (adam, (), ()) if self.name == "adamw" else (adam, ())
        if self.name == "sgd":
            return ((zeros(),) if "momentum" in kw else (), ())
        # rmsprop: scale_by_rms, the learning rate, then the trace
        nu = [torch.full_like(p, kw.get("initial_scale", 0.0)) for p in params]
        return ((nu,), (), (zeros(),) if "momentum" in kw else ())

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state, params: List[torch.Tensor]) -> None:
        kw = self.kw
        neg_lr = -self.lr
        if self.name in ("adam", "adamw"):
            (count, mu, nu) = state[0]
            b1, b2 = kw.get("b1", 0.9), kw.get("b2", 0.999)
            eps, eps_root = kw.get("eps", 1e-8), kw.get("eps_root", 0.0)
            _step_count(count)
            for p, g, m, v in zip(params, grads, mu, nu):
                m.copy_((1 - b1) * g + b1 * m)
                v.copy_((1 - b2) * (g * g) + b2 * v)
                u = _bias_correction(m, b1, count) / (
                    torch.sqrt(_bias_correction(v, b2, count) + eps_root) + eps)
                if self.name == "adamw":
                    u = u + kw.get("weight_decay", 1e-4) * p
                p.copy_(p + neg_lr * u)
            return
        if self.name == "sgd":
            momentum = kw.get("momentum")
            trace = state[0][0] if state[0] else [None] * len(params)
            for p, g, t in zip(params, grads, trace):
                u = g
                if t is not None:
                    t.copy_(g + momentum * t)
                    u = g + momentum * t if kw.get("nesterov") else t
                p.copy_(p + neg_lr * u)
            return
        decay, eps = kw.get("decay", 0.9), kw.get("eps", 1e-8)
        momentum = kw.get("momentum")
        trace = state[2][0] if state[2] else [None] * len(params)
        for p, g, v, t in zip(params, grads, state[0][0], trace):
            v.copy_((1 - decay) * (g * g) + decay * v)
            if kw.get("eps_in_sqrt", True):
                u = torch.rsqrt(v + eps) * g
            else:
                u = g / (torch.sqrt(v) + eps)
            u = neg_lr * u
            if t is not None:
                t.copy_(u + momentum * t)
                u = u + momentum * t if kw.get("nesterov") else t
            p.copy_(p + u)


# the keyword arguments each optimizer takes, as optax's of the same name
_OPTIONS = {
    "adam": ("b1", "b2", "eps", "eps_root"),
    "adamw": ("b1", "b2", "eps", "eps_root", "weight_decay"),
    "sgd": ("momentum", "nesterov"),
    "rmsprop": ("decay", "eps", "initial_scale", "eps_in_sqrt", "momentum", "nesterov"),
}


def make_optimizer(spec: str) -> Optimizer:
    """``"adam,lr=1e-3"`` / ``"sgd,lr=0.1,momentum=0.9"`` → an
    :class:`Optimizer` with optax's semantics and defaults (the learning
    rate defaults to 1e-3).  optax's options this port does not carry
    (``mu_dtype``, ``centered``, ``bias_correction``, Adam's ``nesterov``)
    raise ``ValueError``."""
    parts = [p.strip() for p in str(spec).split(",") if p.strip()]
    if not parts:
        raise ValueError("empty optimizer spec")
    name, kw = parts[0].lower(), {}
    for p in parts[1:]:
        if "=" not in p:
            raise ValueError(f"malformed optimizer option {p!r}")
        k, v = p.split("=", 1)
        kw[k.strip()] = float(v)
    lr = kw.pop("lr", 1e-3)
    if name not in _OPTIONS:
        raise ValueError(f"unknown optimizer {name!r} (adam/adamw/sgd/rmsprop)")
    unknown = sorted(set(kw) - set(_OPTIONS[name]))
    if unknown:
        raise ValueError(f"optimizer {name!r}: unsupported option(s) {unknown}")
    return Optimizer(name, lr, **kw)


# -- params trees -----------------------------------------------------------------

DIFF, STATIC_PY, STATIC_ARR = 0, 1, 2


def tree_flatten(tree) -> Tuple[list, Any]:
    """``(leaves, treedef)`` in ``jax.tree_util``'s order: dict keys sorted,
    lists and tuples in order, ``None`` an empty node; ``treedef`` is
    hashable."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, defs = [], []
        for k in keys:
            sub, d = tree_flatten(tree[k])
            leaves.extend(sub)
            defs.append(d)
        return leaves, ("dict", tuple(keys), tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for v in tree:
            sub, d = tree_flatten(v)
            leaves.extend(sub)
            defs.append(d)
        return leaves, ("list" if isinstance(tree, list) else "tuple", len(tree), tuple(defs))
    if tree is None:
        return [], ("none",)
    return [tree], ("leaf",)


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(d[1], d[2])}
        items = [build(sub) for sub in d[2]]
        return items if kind == "list" else tuple(items)

    return build(treedef)


def _leaf_kind(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return DIFF if leaf.is_floating_point() or leaf.is_complex() else STATIC_ARR
    if isinstance(leaf, np.ndarray):
        return DIFF if leaf.dtype.kind in "fc" else STATIC_ARR
    return STATIC_PY


def split_leaves(params):
    """``(leaves, treedef, mask)``: numpy array leaves as tensors, and each
    leaf's kind (``DIFF``, ``STATIC_PY``, ``STATIC_ARR``)."""
    flat, treedef = tree_flatten(params)
    flat = [torch.from_numpy(np.array(l)) if isinstance(l, np.ndarray) else l for l in flat]
    return flat, treedef, tuple(_leaf_kind(l) for l in flat)


def _state_tensors(state) -> List[torch.Tensor]:
    return [t for t in tree_flatten(state)[0] if isinstance(t, torch.Tensor)]


_captures = itertools.count()
# every live captured step, for the profiler-window check of ROADMAP C16
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


class _Captured:
    """One geometry's captured step: the graph, its static inputs and its
    loss output (each replay rewrites it), the order it was captured in and
    whether the main thread captured it."""

    def __init__(self, graph, static_x, static_y, loss):
        self.graph = graph
        self.static_x = static_x
        self.static_y = static_y
        self.loss = loss
        self.order = next(_captures)
        self.on_main_thread = threading.current_thread() is threading.main_thread()
        _LIVE.add(self)

    def run(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        self._check_profiled_replay()
        self.static_x.copy_(x, non_blocking=True)
        self.static_y.copy_(y, non_blocking=True)
        with launching():
            self.graph.replay()
        return self.loss.clone()

    def _check_profiled_replay(self) -> None:
        """ROADMAP C16: inside a ``torch.profiler`` window (the deep-profiling
        lane's capture lock held), a replay of this graph while a training
        graph captured after it on another thread than the main one lives
        kills the process on the card.  Refuse it typed before the launch."""
        from .obs.profiler import ProfiledReplayHazard, active_capture

        window = active_capture()
        if window is None:
            return
        later = [c for c in list(_LIVE)
                 if c is not self and c.order > self.order and not c.on_main_thread]
        if later:
            raise ProfiledReplayHazard(
                f"ROADMAP C16: a training graph (capture {self.order}) would replay inside "
                f"the profiler window {window.get('capture_id')} while "
                f"{len(later)} training graph(s) captured after it on another thread live; "
                "replay it outside the window or drop the later trainer first")




def _register_memory(entry: _Captured, state: List[torch.Tensor], device) -> None:
    """The captured step's device memory on the cost registry, for the
    deep-profiling lane's ledger (``obs/profiler.hbm_ledger``), under the
    backend's kinds (``obs/device.memory_info``): ``parameter_bytes`` are
    the float parameters and the optimizer state, ``temp_bytes`` the
    graph's pool (the activations kept for the backward, the gradients).
    The record leaves the ledger when the step is dropped."""
    from types import SimpleNamespace

    from .backends.torch_backend import pool_bytes
    from .obs import util as _util
    from .obs.device import memory_info

    hbm = memory_info(SimpleNamespace(static_in=(entry.static_x, entry.static_y),
                                      static_out=(entry.loss,),
                                      pool_bytes=pool_bytes(entry.graph, device)),
                      sum(t.numel() * t.element_size() for t in state))
    fp = _util.register_cost(f"train_step:{entry.order:04d}", model="train_step",
                             bucket=int(entry.static_x.shape[0]) if entry.static_x.dim() else 0,
                             devices=1, hbm=hbm)
    weakref.finalize(entry, _util.release_hbm, fp, hbm)


def make_train_step(apply_fn: Callable, loss: Any = "softmax_ce",
                    optimizer: Any = "adam,lr=1e-3",
                    donate: bool = True) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)``.

    ``init_fn(params) -> opt_state``, over the float leaves in optax's
    layout; ``step_fn(params, opt_state, x, y) -> (params', opt_state',
    loss)``, ``loss`` a float32 scalar tensor on the parameters' device.
    ``loss`` is a name of :data:`LOSSES` or a ``(pred, y) -> scalar``
    callable; ``apply_fn`` is ``(params, x) -> pred``.

    With ``donate`` (the default) the step updates the float leaves and the
    state in place and returns the trees it was given; without it, it
    updates copies, eagerly.  On a card a donating step runs as one CUDA
    graph per geometry (the shapes and dtypes of ``x`` and ``y``, the
    tree's structure and statics, the identity of its tensors)."""
    loss_fn = LOSSES[loss] if isinstance(loss, str) else loss
    tx = make_optimizer(optimizer) if isinstance(optimizer, str) else optimizer
    graphs: Dict[tuple, _Captured] = {}

    def init_fn(params):
        flat, _, mask = split_leaves(params)
        return tx.init([l for l, m in zip(flat, mask) if m == DIFF])

    def compute(flat, treedef, mask, diff, opt_state, x, y) -> torch.Tensor:
        """One step over ``diff`` (the float leaves, updated in place):
        the loss, its gradients, the optimizer's update."""
        with torch.enable_grad():
            live = [d.detach().requires_grad_(True) for d in diff]
            it = iter(live)
            params = tree_unflatten(treedef, [next(it) if m == DIFF else l
                                              for l, m in zip(flat, mask)])
            value = loss_fn(apply_fn(params, x), y)
            grads = torch.autograd.grad(value, live, allow_unused=True)
        grads = [torch.zeros_like(d) if g is None else g for d, g in zip(diff, grads)]
        tx.update(grads, opt_state, diff)
        return value.detach()

    def captured(flat, treedef, mask, diff, opt_state, x, y, device) -> _Captured:
        """Capture the step for this geometry (``capture_calls``), the
        state put back after the warm-up calls so that they do not train."""
        from .backends.torch_backend import capture_calls

        state = diff + _state_tensors(opt_state)
        statics = tuple((type(l).__name__, l) for l, m in zip(flat, mask) if m == STATIC_PY)
        key = (treedef, mask, tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               tuple(t.data_ptr() for t in state), statics)
        try:
            entry = graphs.get(key)
        except TypeError:  # an unhashable static: capture afresh
            key, entry = None, None
        if entry is not None:
            return entry
        static_x, static_y = x.to(device, copy=True), y.to(device, copy=True)
        saved = [t.clone() for t in state]
        graph, loss_out, _, _ = capture_calls(
            lambda: compute(flat, treedef, mask, diff, opt_state, static_x, static_y),
            static_x.device, inference=False)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        entry = _Captured(graph, static_x, static_y, loss_out)
        _register_memory(entry, state, device)
        if key is not None:
            graphs[key] = entry
        return entry

    def step(params, opt_state, x, y):
        flat, treedef, mask = split_leaves(params)
        if not donate:
            flat = [l.clone() if m != STATIC_PY else l for l, m in zip(flat, mask)]
            opt_state = tree_unflatten(*_clone_state(opt_state))
        diff = [l for l, m in zip(flat, mask) if m == DIFF]
        device = diff[0].device if diff else torch.device("cpu")
        x, y = _as_tensor(x), _as_tensor(y)
        if donate and device.type == "cuda":
            value = captured(flat, treedef, mask, diff, opt_state, x, y, device).run(x, y)
        else:
            value = compute(flat, treedef, mask, diff, opt_state, x.to(device), y.to(device))
        return tree_unflatten(treedef, flat), opt_state, value

    return init_fn, step


def _as_tensor(a) -> torch.Tensor:
    """A frame's payload as a tensor (a numpy array, or a wire-layout
    payload through its numpy view)."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _clone_state(state):
    leaves, treedef = tree_flatten(state)
    return treedef, [l.clone() if isinstance(l, torch.Tensor) else l for l in leaves]
