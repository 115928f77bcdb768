"""Observability: the hook bus, metrics, tracers, spans and exposition.

The port's copy of the JAX package's ``obs`` package, the part that needs
no device runtime:

- :mod:`.hooks` — a near-zero-overhead hook bus wired into the graph core
  (pad pushes, dispatch enter/exit, queue push/pop/drop, source spawn and
  push, state changes, errors, host copies, the filter's device dispatch,
  segment installs);
- :mod:`.metrics` — labeled counter/gauge/histogram registry;
- :mod:`.tracers` — pluggable ``latency`` / ``stats`` / ``drops`` /
  ``copies`` tracers;
- :mod:`.spans` / :mod:`.flight` — per-frame span tracing
  (``NNSTPU_TRACERS=spans``): trace-context stamping, a bounded
  per-thread flight recorder, Chrome-trace/Perfetto + waterfall export;
- :mod:`.export` — Prometheus text exposition + stdlib scrape endpoint
  (plus ``/healthz``, the merged ``/stats.json`` and ``/alerts``).

Activation is conf-driven — ``NNSTPU_TRACERS=latency;stats`` and
``NNSTPU_METRICS_PORT=9464`` (the short spellings take precedence;
``NNSTPU_COMMON_TRACERS`` / ``NNSTPU_COMMON_METRICS_PORT`` and the ini
``[common]`` keys also work) — or programmatic via
``pipeline.attach_tracer("latency")``.

Not ported yet: the device lane, the utilization and cost models, the
deep-profiling lane, the watchdog, recovery accounting, the cluster
collector, tail forensics and the SLO engine (``obs/{device,util,
costmodel,profiler,watchdog,recovery,collector,forensics,slo}.py``).
"""

from __future__ import annotations

import os
from typing import List, Optional

from . import hooks  # noqa: F401
from .export import (  # noqa: F401
    MetricsServer,
    ensure_server,
    health_snapshot,
    register_health,
    register_stats,
    render_text,
    shutdown_server,
    stats_snapshot,
    unregister_health,
    unregister_stats,
)
from .flight import FlightRecorder  # noqa: F401
from .metrics import (  # noqa: F401
    LATENCY_BUCKETS_MS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    configured_latency_buckets,
)
from .tracers import (  # noqa: F401
    TRACERS,
    CopiesTracer,
    DropsTracer,
    LatencyTracer,
    StatsTracer,
    Tracer,
    make_tracer,
    parse_tracer_names,
)

# importing .spans registers the "spans" tracer with TRACERS
from . import spans  # noqa: E402,F401
from .spans import SpanTracer, chrome_trace, waterfall  # noqa: F401


def configured_tracers() -> List[str]:
    """Tracer names requested by the environment/conf (may be empty)."""
    val = os.environ.get("NNSTPU_TRACERS")
    if val is None:
        from ..conf import conf

        val = conf.get("common", "tracers", "") or ""
    return parse_tracer_names(val)


def configured_metrics_port() -> Optional[int]:
    """Scrape-endpoint port from the environment/conf; None = disabled."""
    val = os.environ.get("NNSTPU_METRICS_PORT")
    if val is None:
        from ..conf import conf

        val = conf.get("common", "metrics_port", "")
    if val in (None, ""):
        return None
    return int(val)
