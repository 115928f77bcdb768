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
  (plus ``/healthz``, the merged ``/stats.json`` and ``/alerts``);
- :mod:`.device` — the device lane (``NNSTPU_TRACERS=device``): device
  timing of each filter dispatch from a CUDA event pair, capture
  accounting (``nnstpu_compile_*``) and the card's memory gauges, sampled
  at scrape time while the tracer is attached;
- :mod:`.util` — the utilization lane: the per-capture cost registry, MFU
  and roofline math against the card's peaks, busy and idle accounting,
  and the host-to-device wire probe;
- :mod:`.recovery` — the accounting of self-healing actions
  (``nnstpu_recovery_total``);
- :mod:`.watchdog` — the pipeline health watchdog (``NNSTPU_TRACERS=watchdog``):
  stalled sources, wedged queues and overdue device dispatches flip
  ``nnstpu_health`` and ``/healthz``, write a stall flight dump, and with
  ``[obs] watchdog_recover`` escalate to restart, drain and breaker trips,
  and with ``[obs] profile_auto`` a device-time degradation starts a
  capture;
- :mod:`.profiler` — the deep-profiling lane: ``torch.profiler`` capture
  windows (``/profile``) into a bounded gallery, the table of device ops
  per capture, the whole-run trace of ``[common] xplane_trace_dir`` and the
  captured graphs' memory ledger (importing it installs the
  ``nnstpu_executable_hbm_bytes`` scrape collector).

Activation is conf-driven — ``NNSTPU_TRACERS=latency;stats`` and
``NNSTPU_METRICS_PORT=9464`` (the short spellings take precedence;
``NNSTPU_COMMON_TRACERS`` / ``NNSTPU_COMMON_METRICS_PORT`` and the ini
``[common]`` keys also work) — or programmatic via
``pipeline.attach_tracer("latency")``.

The cluster layer:

- :mod:`.costmodel` — the cost observatory (``costmodel`` tracer): the
  per-stage compute-vs-transfer cost model from the hook bus, exported as
  ``nnstpu_stage_cost_us`` gauges and the ``cost_model`` stats provider,
  persisted idempotently to ``COST_MODEL.json`` in the JAX package's
  schema;
- :mod:`.slo` — the burn-rate SLO engine behind ``/alerts`` and the
  ``alert`` hook;
- :mod:`.collector` — cluster collection: ``/trace.json`` snapshots merged
  into one clock-aligned Perfetto trace, per-worker ``/metrics`` and
  ``/alerts`` federated, one request's spans decomposed into latency legs;
- :mod:`.forensics` — tail forensics (``forensics`` tracer): typed
  root-cause verdicts for latency outliers and a bounded capture gallery.

Not ported yet: the partition edges of ``obs/util.py``'s wire health.
"""

from __future__ import annotations

import os
from typing import List, Optional

from . import hooks  # noqa: F401
from .export import (  # noqa: F401
    MetricsServer,
    ensure_server,
    health_snapshot,
    register_alerts,
    register_health,
    register_stats,
    set_health_nonce,
    render_text,
    shutdown_server,
    stats_snapshot,
    unregister_alerts,
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
from . import recovery  # noqa: E402,F401
from .util import (  # noqa: F401
    DeviceUsage,
    busy_fraction,
    cost_of,
    idle_gaps,
    last_wire_health,
    merge_intervals,
    peak_gbs,
    peak_tflops,
    probe_wire_health,
    publish_wire_health,
    register_cost,
    roofline,
    wire_regime,
)

# importing .device registers the "device" tracer with TRACERS
from .device import (  # noqa: E402,F401
    DeviceTracer,
    device_memory_snapshot,
    record_compile,
    register_memory_gauges,
)

# importing .watchdog registers the "watchdog" tracer with TRACERS
from .watchdog import PipelineWatchdog  # noqa: E402,F401

# the deep-profiling lane; importing it installs the memory-ledger gauges
from . import profiler  # noqa: E402,F401
from .profiler import (  # noqa: E402,F401
    DegradeDetector,
    HbmCapacityWarning,
    ProfileBusyError,
    ProfileGallery,
    annotate_chrome_trace,
    capture_profile,
    check_hbm_capacity,
    hbm_ledger,
    parse_capture_dir,
    profiled_window,
)


# importing .costmodel / .forensics registers the "costmodel" /
# "forensics" tracers; .slo is the burn-rate engine behind /alerts
from . import costmodel  # noqa: E402,F401
from .costmodel import (  # noqa: E402,F401
    CostModelTracer,
    cost_model_path,
    load_cost_model,
    merge_cost_model,
)
from . import collector  # noqa: E402,F401
from .collector import (  # noqa: E402,F401
    TraceCollector,
    attribute_trace,
    federate_metrics,
    fetch_alerts,
    merge_alerts,
    set_process_name,
    trace_document,
)
from . import forensics  # noqa: E402,F401
from . import slo  # noqa: E402,F401
from .forensics import ForensicsEngine, ForensicsTracer  # noqa: E402,F401
from .slo import SloEngine, parse_objectives  # noqa: E402,F401


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
