"""Fault injection: the chaos substrate of the self-healing runtime.

The port's copy of the JAX package's ``faults`` package.  This is the
*test side* of the robustness story; the recovery side lives in the graph
runtime (``graph/pipeline.py``'s restart policies, ``Queue.recover``):

- :mod:`.engine` — the deterministic, seeded :class:`ChaosEngine` and the
  ``NNSTPU_FAULTS`` spec grammar, which parses every kind of the JAX
  package;
- this module — the process-global activation surface, mirroring the hook
  bus (:mod:`nnstreamer_tpu_torch.obs.hooks`): hot sites guard every
  consultation with ``if faults.enabled:``, so a run with no chaos
  configured pays one module-attribute truth test.

Activation:

- ``NNSTPU_FAULTS="seed=42;invoke_raise@f:every=5"`` (or ini ``[faults]
  spec`` / ``NNSTPU_FAULTS_SPEC``), picked up by ``Pipeline.start`` through
  :func:`ensure_configured`;
- programmatic: ``faults.install("invoke_delay:rate=0.1,ms=20", seed=7)``
  and ``faults.deactivate()`` (tests).

The port's injection points:

===================  ===================================================
``backend_invoke``   ``TensorFilter.process``, before the invoke and
                     outside any capture — ``invoke_delay`` /
                     ``device_stall`` (sleep ``ms``), ``invoke_raise``
                     (:class:`~.engine.InjectedFault`)
``backend_compile``  ``TorchBackend``'s selection of a capture for a
                     geometry, before the capture and never inside
                     ``torch.cuda.graph`` — ``compile_raise``.  There is
                     no CPU fallback: the fault goes to the node's restart
                     policy, or fails the pipeline
``queue_wedge``      the ``queue`` element's worker loop — sleep ``ms``
                     without popping (depth builds)
``nnsq_send``        every NNSQ send (``elements/query.py::send_tensors``,
                     on the assembled frame bytes): ``socket_drop`` /
                     ``truncate`` / ``corrupt`` (:func:`on_wire`); the
                     sites are named ``nnsq.client``, ``nnsq.server`` and
                     ``nnsq.repo``
===================  ===================================================

The JAX package's ``fleet``, ``migrate`` and ``autoscale`` points wait for
the port of the fleet tier (ROADMAP item 14).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .engine import (  # noqa: F401
    DEFAULT_MS,
    KINDS,
    POINT_OF,
    ChaosEngine,
    FaultRule,
    InjectedFault,
    parse_spec,
)

# The fast-path gate: one module-global truth test when chaos is off (the
# discipline of obs.hooks.enabled).
enabled = False

_lock = threading.Lock()
_engine: Optional[ChaosEngine] = None


def engine() -> Optional[ChaosEngine]:
    return _engine


def install(spec: str, seed: Optional[int] = None) -> ChaosEngine:
    """Activate a chaos engine for this process (replacing any previous
    one); returns it, so callers can read ``engine.log`` and
    ``engine.stats()`` after the run."""
    global _engine, enabled
    eng = ChaosEngine(spec, seed)
    with _lock:
        _engine = eng
        enabled = bool(eng.rules)
    return eng


def deactivate() -> None:
    global _engine, enabled
    with _lock:
        _engine = None
        enabled = False


def configured_spec() -> str:
    """The conf'd spec: the short env ``NNSTPU_FAULTS`` wins over the
    ``[faults] spec`` forms (the ``NNSTPU_TRACERS`` precedence)."""
    spec = os.environ.get("NNSTPU_FAULTS")
    if spec is not None:
        return spec
    from ..conf import conf

    return conf.get("faults", "spec", "") or ""


def ensure_configured() -> Optional[ChaosEngine]:
    """Conf-driven activation, called from ``Pipeline.start``: installs the
    configured spec once (idempotent for an unchanged spec: counters and
    the log survive restarts of the same chaos run).  An empty conf spec
    never tears down a programmatically installed engine."""
    spec = configured_spec()
    if not spec:
        return _engine
    from ..conf import conf

    seed = conf.get_int("faults", "seed", 0)
    with _lock:
        cur = _engine
    if cur is not None and cur.spec == spec and cur.seed == parse_spec(spec, seed)[0]:
        return cur
    return install(spec, seed)


# -- injection helpers (one per point; call only behind `if enabled:`) -----


def maybe_invoke(name: str) -> None:
    """``backend_invoke`` point: may sleep (``invoke_delay`` /
    ``device_stall``) or raise :class:`InjectedFault` (``invoke_raise``)."""
    eng = _engine
    if eng is None:
        return
    rule = eng.decide("backend_invoke", name)
    if rule is None:
        return
    if rule.kind == "invoke_raise":
        raise InjectedFault(rule.kind, name, rule.opportunities)
    eng.sleep(rule)


def maybe_compile(name: str) -> None:
    """``backend_compile`` point: ``compile_raise`` raises."""
    eng = _engine
    if eng is None:
        return
    rule = eng.decide("backend_compile", name)
    if rule is not None:
        raise InjectedFault(rule.kind, name, rule.opportunities)


def maybe_queue_wedge(name: str) -> None:
    """``queue_wedge`` point: sleep ``ms`` in the consumer loop, so the
    queue stops popping while pushes accumulate."""
    eng = _engine
    if eng is None:
        return
    rule = eng.decide("queue_wedge", name)
    if rule is not None:
        eng.sleep(rule)


def on_wire(sock, data: bytes, name: str) -> bytes:
    """``nnsq_send`` point, called with the fully assembled frame bytes:

    - ``socket_drop``: close the socket, send nothing, raise
      ``ConnectionError`` (the local sender sees the drop; the peer sees
      a clean close);
    - ``truncate``: send a torn half-frame, close, raise (the peer's
      ``_recv_exact`` must detect the torn frame);
    - ``corrupt``: flip one payload byte in the final quarter of the
      frame (header fields survive; tensor values do not).
    """
    eng = _engine
    if eng is None:
        return data
    rule = eng.decide("nnsq_send", name)
    if rule is None:
        return data
    if rule.kind == "corrupt":
        buf = bytearray(data)
        buf[-max(1, len(buf) // 4)] ^= 0xFF
        return bytes(buf)
    try:
        if rule.kind == "truncate" and len(data) > 1:
            sock.sendall(data[: len(data) // 2])
    finally:
        try:
            import socket as _socket

            sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
    raise ConnectionError(
        f"injected {rule.kind} at {name!r} "
        f"(opportunity {rule.opportunities})")
