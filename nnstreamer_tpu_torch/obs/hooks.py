"""Near-zero-overhead hook bus: the GstTracer hook-point analog.

The port's copy of the JAX package's ``obs/hooks.py``.  GStreamer's tracer
subsystem exposes named hook points (``pad-push-pre``,
``element-post-message``, ...) that tracer plugins attach to; with no
tracer loaded the hooks compile down to a flag test.  This module is that
bus for the port's graph runtime:

- hot-path sites guard every emission with ``if hooks.enabled:`` — one
  module-global load + truth test when nothing is attached (pinned by the
  micro-benchmark in ``tests/test_torch_obs.py``);
- callbacks are held in per-hook tuples, swapped atomically under a lock
  on connect/disconnect, iterated lock-free on emit;
- a callback that raises is disabled after logging once — observability
  must never take the pipeline down.

Every hook fires on the host, around the work it describes: none fires
inside a function that a CUDA graph captures, so a replay runs the same
device work with tracers attached or not.

The table below is the JAX package's, point for point and argument for
argument (``analysis/lint.py`` checks every ``hooks.emit`` site of the
repo against the last ``HOOK_SIGNATURES`` it reads, which is this one).
The port emits ``pad_push``, ``dispatch_enter``/``dispatch_exit``,
``queue_push``/``queue_pop``/``queue_drop``, ``source_push``,
``source_spawn``, ``state_change``, ``error``, ``copy``,
``device_dispatch`` and ``segment``; the other points belong to elements
and subsystems not ported yet.  On the port ``device_dispatch``'s ``outs``
are the filter's output tensors (a CUDA graph's replay, already enqueued).

Hook points and their emit signatures (positional, no kwargs — emission
must stay allocation-light):

=================  ====================================================
``pad_push``       ``(pad, item)`` — a src pad pushed a frame/event
``dispatch_enter`` ``(node, pad, item, t0_ns)`` — sink-side entry
``dispatch_exit``  ``(node, pad, item, dur_ns)`` — sink-side exit
``queue_push``     ``(node, depth)`` — frame-queue push (post-push depth)
``queue_pop``      ``(node, depth)`` — frame-queue pop (post-pop depth)
``queue_drop``     ``(node, reason)`` — leaky drop ("downstream"/"upstream")
``source_push``    ``(pipeline, node, frame)`` — source-thread push, pre-chain
``source_spawn``   ``(pipeline, node)`` — streaming thread spawned
``state_change``   ``(pipeline, old, new)`` — pipeline state transition
``error``          ``(pipeline, node, exc)`` — posted pipeline error
``rate_drop``      ``(node,)`` — tensor_rate dropped a frame
``rate_dup``       ``(node,)`` — tensor_rate duplicated a frame
``dynbatch_flush`` ``(node, n, bucket)`` — dynbatch emitted a batch
``copy``           ``(node, nbytes, allocs)`` — a hot-path host memcpy
                   (batch assembly, wire staging, forced materialization);
                   ``allocs`` counts fresh buffer allocations (0 when the
                   bytes landed in a recycled pool buffer).  ``node`` may
                   be a backend object on filter-internal copies.
``device_dispatch`` ``(node, frame, outs, t0_ns)`` — a filter handed work
                   to an async device runtime (JAX dispatch returned;
                   the device may still be executing).  ``outs`` are the
                   returned arrays — probing their readiness is how the
                   device tracer recovers TRUE device timing.
``compile``        ``(backend, key, result, dur_ns, info)`` — an
                   executable-cache event on a filter backend.  ``result``
                   is ``"hit"``/``"miss"``/``"evict"``; ``dur_ns`` is the
                   compile wall time (0 for hit/evict); ``info`` is a dict
                   with ``flops``/``bytes`` from ``cost_analysis()`` when
                   the runtime exposes them (else empty).
``health``         ``(pipeline, healthy, reason)`` — the pipeline
                   watchdog flipped health state (``reason`` names the
                   stalled source / wedged queue / overdue dispatch).
``fault``          ``(point, kind, target)`` — the chaos engine
                   (``faults``) injected a fault at
                   an instrumented point.
``recovery``       ``(pipeline_name, action, target, result)`` — a
                   self-healing action ran (node restart, quarantine,
                   watchdog escalation, backend CPU fallback);
                   ``result`` is ``ok``/``error``/``storm``/
                   ``escalate``.  The first argument is the pipeline
                   NAME (string, may be empty for backend-level
                   actions), not the object.
``scale_event``    ``(name, action, worker, detail)`` — the fleet
                   autoscaler (``fleet/autoscaler``)
                   or its supervisor acted: ``action`` is ``spawn`` /
                   ``join`` / ``spawn_fail`` / ``drain`` / ``respawn``
                   / ``quarantine`` / ``release`` / ``flap_damped`` /
                   ``storm``; ``worker`` names the target (may be empty
                   for fleet-wide actions) and ``detail`` carries the
                   WHY (threshold crossed, crash count, budget state).
``lane_promote``   ``(pipeline, task, reason)`` — the dispatcher-lane
                   runtime (``graph/lanes``) shunted
                   a blocking task to its helper pool; ``task`` is the
                   logical task name (``src:<n>``/``queue:<n>``),
                   ``reason`` is ``hint:ok``/``measured:ok``/
                   ``…:denied`` (helper pool exhausted).
``warmup``         ``(pipeline, node_name, label, done, total,
                   dur_ns)`` — compile-ahead warmup progress
                   (``graph/warmup``): one emission
                   per warmed executable (``label`` names the
                   geometry), plus a final ``label=""`` emission when
                   the phase completes (``dur_ns`` then carries the
                   whole-phase wall time).  ``pipeline`` may be None
                   for serverless warmups (QueryServer, fleet worker).
``device_exec``    ``(pipeline_name, node_name, device, t0_ns, dur_ns,
                   info)`` — the device-lane reaper observed one TRUE
                   device completion (enqueue→done; one emission per
                   mesh shard under sharded dispatch).  ``info`` is a
                   dict with ``bucket``/``mesh``/``flops``/``bytes``/
                   ``mfu`` when the executable's cost profile is
                   registered (else partial/empty) — the feed the
                   cost-model tracer (:mod:`.costmodel`) aggregates.
``segment``        ``(pipeline_name, filter_name, label, detail,
                   action)`` — whole-segment compilation
                   (``graph/segments``) installed or
                   restored a fused region on a filter: ``label`` is the
                   segment's element-chain tag (also the cost-registry /
                   exec-cache tag), ``detail`` summarizes the fold
                   (pre/post/fallback counts; empty on restore),
                   ``action`` is ``install`` / ``restore``.
``alert``          ``(name, state, severity, detail)`` — the SLO
                   burn-rate engine (``obs/slo``)
                   changed an alert's state: ``name`` is the objective,
                   ``state`` is ``firing`` / ``resolved``, ``severity``
                   is ``page`` (fast window) / ``ticket`` (slow only),
                   ``detail`` carries the burn rates and windows that
                   crossed.
``profile``        ``(pipeline_name, action, detail)`` — the deep-
                   profiling lane (``obs/profiler``)
                   moved a capture through its lifecycle: ``action`` is
                   ``start`` / ``end`` / ``abort`` / ``error`` /
                   ``hbm_over_capacity``; ``detail`` carries the
                   capture id plus the op/frame counts (or the failure
                   reason).  ``pipeline_name`` may be empty for
                   backend-level windows (bench, ``device_trace``).
=================  ====================================================

Timestamps passed through hooks are ``time.perf_counter_ns()`` — every
producer and consumer must use that one clock.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Tuple

_LOG = logging.getLogger("nnstreamer_tpu_torch.obs")

# The machine-readable registry behind the docstring table above: hook
# point -> positional emit signature, equal to the JAX package's dict.
# ``analysis/lint.py`` cross-checks every ``hooks.emit(name, ...)`` site
# of the repo against the last such dict it reads, which is this one: a
# subset or a renamed point here fails the JAX package's sites.
HOOK_SIGNATURES: Dict[str, Tuple[str, ...]] = {
    "pad_push": ("pad", "item"),
    "dispatch_enter": ("node", "pad", "item", "t0_ns"),
    "dispatch_exit": ("node", "pad", "item", "dur_ns"),
    "queue_push": ("node", "depth"),
    "queue_pop": ("node", "depth"),
    "queue_drop": ("node", "reason"),
    "source_push": ("pipeline", "node", "frame"),
    "source_spawn": ("pipeline", "node"),
    "state_change": ("pipeline", "old", "new"),
    "error": ("pipeline", "node", "exc"),
    "rate_drop": ("node",),
    "rate_dup": ("node",),
    "dynbatch_flush": ("node", "n", "bucket"),
    "copy": ("node", "nbytes", "allocs"),
    "device_dispatch": ("node", "frame", "outs", "t0_ns"),
    "compile": ("backend", "key", "result", "dur_ns", "info"),
    "health": ("pipeline", "healthy", "reason"),
    "fault": ("point", "kind", "target"),
    "recovery": ("pipeline_name", "action", "target", "result"),
    "warmup": ("pipeline", "node_name", "label", "done", "total", "dur_ns"),
    "lane_promote": ("pipeline", "task", "reason"),
    "scale_event": ("name", "action", "worker", "detail"),
    "device_exec": ("pipeline_name", "node_name", "device", "t0_ns",
                    "dur_ns", "info"),
    "segment": ("pipeline_name", "filter_name", "label", "detail", "action"),
    "alert": ("name", "state", "severity", "detail"),
    "profile": ("pipeline_name", "action", "detail"),
}

HOOKS = tuple(HOOK_SIGNATURES)

# The fast-path gate: True iff at least one callback is connected anywhere.
# Hot sites read this module attribute directly; everything past the gate
# only runs while tracing is active.
enabled = False

_lock = threading.Lock()
_callbacks: Dict[str, Tuple[Callable, ...]] = {h: () for h in HOOKS}


def connect(hook: str, fn: Callable) -> None:
    """Attach ``fn`` to a hook point (idempotent per (hook, fn) pair)."""
    global enabled
    if hook not in _callbacks:
        raise ValueError(f"unknown hook {hook!r} (known: {', '.join(HOOKS)})")
    with _lock:
        if fn not in _callbacks[hook]:
            _callbacks[hook] = _callbacks[hook] + (fn,)
        enabled = True


def disconnect(hook: str, fn: Callable) -> None:
    global enabled
    with _lock:
        # equality, not identity: bound methods (a common callback shape)
        # are re-created on every attribute access
        _callbacks[hook] = tuple(f for f in _callbacks[hook] if f != fn)
        enabled = any(_callbacks.values())


def clear() -> None:
    """Detach everything (test isolation)."""
    global enabled
    with _lock:
        for h in _callbacks:
            _callbacks[h] = ()
        enabled = False


def emit(hook: str, *args) -> None:
    """Run every callback attached to ``hook``.  A raising callback is
    logged and disconnected — tracers are observers, never participants."""
    for fn in _callbacks[hook]:
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 — observability must not kill flow
            _LOG.exception("tracer callback %r on hook %r failed; detaching",
                           fn, hook)
            disconnect(hook, fn)
