"""Shared accounting for self-healing actions.

The port's copy of the JAX package's ``obs/recovery.py``.  Every recovery
path of the graph runtime (node restarts and quarantines, source restarts,
queue drains) and the watchdog's breaker trips (``obs/watchdog.py``, on an
overdue device) report through :func:`record`, so one counter family answers
"what did the system do to keep itself alive, and did it work":

    nnstpu_recovery_total{pipeline,action,result}

plus the ``recovery`` hook (``(pipeline_name, action, target, result)``)
for tracers and a flight-recorder instant when span tracing is active —
a self-healing event leaves the same forensic trail as the failure that
triggered it.
"""

from __future__ import annotations

import logging

_LOG = logging.getLogger("nnstreamer_tpu_torch.obs")


def _recovery_counter():
    # looked up per action (recoveries are rare): a registry reset between
    # runs never leaves a stale counter behind
    from .metrics import REGISTRY

    return REGISTRY.counter(
        "nnstpu_recovery_total",
        "self-healing actions taken, by action and outcome",
        labelnames=("pipeline", "action", "result"),
    )


def record(pipeline: str, action: str, result: str, target: str = "",
           detail: str = "") -> None:
    """One recovery action: ``action`` names what was attempted
    (``restart_node``, ``quarantine``, ``restart_source``,
    ``drain_queue``, and the watchdog's ``breaker_trip``), ``result`` its
    outcome (``ok`` / ``error`` / ``storm`` / ``escalate``)."""
    try:
        _recovery_counter().inc(
            1, pipeline=pipeline or "", action=action, result=result)
    except Exception:  # noqa: BLE001 — accounting must not block recovery
        pass
    _LOG.warning("recovery: pipeline=%r action=%s target=%s result=%s%s",
                 pipeline, action, target, result,
                 f" ({detail})" if detail else "")
    try:
        from . import hooks as _hooks
        from . import spans as _spans

        if _spans.enabled:
            _spans.record_instant(
                f"recovery:{action}", cat="health", trace=(0, 0),
                args={"target": target, "result": result, "detail": detail})
        if _hooks.enabled:
            _hooks.emit("recovery", pipeline, action, target, result)
    except Exception:  # noqa: BLE001
        pass
