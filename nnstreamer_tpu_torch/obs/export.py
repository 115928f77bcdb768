"""Prometheus exposition: text rendering + a stdlib scrape endpoint.

The port's copy of the JAX package's ``obs/export.py``.  ``render_text``
serializes a :class:`~nnstreamer_tpu_torch.obs.metrics.MetricsRegistry` in
the Prometheus text format (version 0.0.4: ``# HELP`` / ``# TYPE`` headers,
``_bucket{le=...}/_sum/_count`` histogram series), byte for byte as the
JAX package does.  ``MetricsServer`` serves it over plain ``http.server``
— no dependency, one named daemon thread — at ``/metrics`` and ``/``;
activation is conf-driven from ``Pipeline.start``
(``NNSTPU_METRICS_PORT=9464``) or programmatic.

Beyond ``/metrics`` the server answers ``/healthz`` (liveness probe: a
JSON ``{"status": "ok"|"warming"|"degraded"|"unhealthy", ...}`` document
carrying every provider's reason — ``degraded`` and ``warming`` stay 200,
``unhealthy`` turns 503 once any registered health provider reports
unhealthy; the pipeline watchdog, ``obs/watchdog.py``, registers one a
pipeline), ``/stats.json`` — every registered stats provider (each
pipeline, from ``Pipeline.start``) merged into one JSON document, the
structured twin of the Prometheus exposition — and ``/alerts``, the empty
document of a process with no objectives.

``GET /profile?seconds=N&frames=M`` runs one deep-profiling window
(``obs/profiler.py`` :func:`~.profiler.capture_profile`, trigger
``http``) on the handler's thread and answers its summary (200), 409 with
``{"error": "busy"}`` while another capture or a whole-run trace holds the
profiler, and 400 on parameters that do not parse.  Not ported yet, and
answered 404 until its module is: ``/trace.json`` (the flight snapshot a
cluster collector federates, ``obs/collector.py``).  The
SLO engine behind ``/alerts`` (``obs/slo.py``, which the JAX package's
server starts with itself) and the fleet's incarnation nonce in
``/healthz`` come with the subsystems that use them.  The serving engine's
``stats()`` reaches the scrape as ``nnstpu_serving_*`` gauges through
:func:`register_engine` (``ContinuousBatcher.publish_metrics``).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from .metrics import REGISTRY, MetricsRegistry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_stats_lock = threading.Lock()
_stats_providers: Dict[str, Callable[[], dict]] = {}


def register_stats(name: str, fn: Callable[[], dict]) -> Callable[[], dict]:
    """Publish a ``stats()``-style callable under ``name`` in the
    ``/stats.json`` document (idempotent; a re-register replaces)."""
    with _stats_lock:
        _stats_providers[name] = fn
    return fn


def unregister_stats(name: str, fn: Optional[Callable] = None) -> None:
    """Remove a provider.  Passing ``fn`` makes removal conditional on
    the mapping still pointing at it — two same-named registrants don't
    tear each other down."""
    with _stats_lock:
        if fn is None or _stats_providers.get(name) is fn:
            _stats_providers.pop(name, None)


def stats_snapshot() -> dict:
    """Every registered provider's snapshot; a raising provider becomes
    an ``{"error": ...}`` entry, never a 500 (same contract as registry
    collectors)."""
    with _stats_lock:
        providers = dict(_stats_providers)
    out = {}
    for name, fn in providers.items():
        try:
            out[name] = fn()
        except Exception as exc:  # noqa: BLE001 — one bad provider != no stats
            out[name] = {"error": repr(exc)}
    return out


_health_lock = threading.Lock()
_health_providers: Dict[str, Callable[[], tuple]] = {}


def register_health(name: str, fn: Callable[[], tuple]) -> Callable:
    """Register a health provider under ``name``: a callable returning
    ``(healthy: bool, reason: str)``.  While any provider reports
    unhealthy, ``/healthz`` answers 503 with the reasons (the pipeline
    watchdog, :class:`~.watchdog.PipelineWatchdog`, registers one per
    pipeline while it runs)."""
    with _health_lock:
        _health_providers[name] = fn
    return fn


def unregister_health(name: str, fn: Optional[Callable] = None) -> None:
    with _health_lock:
        if fn is None or _health_providers.get(name) is fn:
            _health_providers.pop(name, None)


_warming_lock = threading.Lock()
_warming_providers: Dict[str, Callable[[], str]] = {}


def register_warming(name: str, fn: Callable[[], str]) -> Callable:
    """Register a *warming* provider: a callable returning a reason
    string ("" = done).  Warming is the compile-ahead phase — the worker
    is healthy and will serve shortly, but fleet membership must not
    route traffic yet (suspend-dispatch, not unhealthy: /healthz stays
    200 and the body carries ``status: "warming"``)."""
    with _warming_lock:
        _warming_providers[name] = fn
    return fn


def unregister_warming(name: str, fn: Optional[Callable] = None) -> None:
    with _warming_lock:
        if fn is None or _warming_providers.get(name) is fn:
            _warming_providers.pop(name, None)


def warming_snapshot() -> Dict[str, str]:
    """{provider: reason} for every provider still warming up."""
    with _warming_lock:
        providers = dict(_warming_providers)
    out: Dict[str, str] = {}
    for name, fn in providers.items():
        try:
            reason = fn()
        except Exception as exc:  # noqa: BLE001
            reason = f"warming provider raised: {exc!r}"
        if reason:
            out[name] = reason
    return out


_degraded_lock = threading.Lock()
_degraded_providers: Dict[str, Callable[[], str]] = {}


def register_degraded(name: str, fn: Callable[[], str]) -> Callable:
    """Register a *degraded* provider: a callable returning a reason
    string ("" = fine).  Degradation is service-continuity with reduced
    capability (e.g. a filter backend that fell back to CPU after a
    device loss) — ``/healthz`` stays **200** but its body carries the
    reasons, so operators see the reduced state without probes declaring
    an outage."""
    with _degraded_lock:
        _degraded_providers[name] = fn
    return fn


def unregister_degraded(name: str, fn: Optional[Callable] = None) -> None:
    with _degraded_lock:
        if fn is None or _degraded_providers.get(name) is fn:
            _degraded_providers.pop(name, None)


def degraded_snapshot() -> Dict[str, str]:
    """{provider: reason} for every provider currently degraded."""
    with _degraded_lock:
        providers = dict(_degraded_providers)
    out: Dict[str, str] = {}
    for name, fn in providers.items():
        try:
            reason = fn()
        except Exception as exc:  # noqa: BLE001
            reason = f"degraded provider raised: {exc!r}"
        if reason:
            out[name] = reason
    return out


def alerts_document() -> dict:
    """The ``/alerts`` JSON body of a process with no SLO engine: no
    objectives, nothing firing (collectors can probe unconditionally)."""
    return {"objectives": {}, "firing": []}


def health_snapshot() -> Tuple[bool, Dict[str, str]]:
    """(overall healthy, {provider: reason for each unhealthy one}).  A
    raising provider counts as unhealthy — a broken watchdog must not
    read as a green check."""
    with _health_lock:
        providers = dict(_health_providers)
    failures: Dict[str, str] = {}
    for name, fn in providers.items():
        try:
            healthy, reason = fn()
        except Exception as exc:  # noqa: BLE001
            healthy, reason = False, f"health provider raised: {exc!r}"
        if not healthy:
            failures[name] = reason or "unhealthy"
    return (not failures), failures


def health_document() -> dict:
    """The structured health verdict served at ``/healthz`` (and merged
    into ``/stats.json`` under ``"health"``): ``status`` is ``"ok"``,
    ``"warming"`` (compile-ahead in progress — healthy, suspend dispatch;
    still HTTP 200), ``"degraded"`` (serving with reduced capability —
    e.g. a cpu-fallback backend; still HTTP 200) or ``"unhealthy"``
    (503), with the per-provider *reasons* alongside so fleet membership
    and human operators see WHY a worker is deprioritized, not just the
    flag."""
    healthy, failures = health_snapshot()
    degraded = degraded_snapshot()
    warming = warming_snapshot()
    status = ("unhealthy" if not healthy
              else "warming" if warming
              else "degraded" if degraded else "ok")
    doc = {"status": status, "failures": failures, "degraded": degraded}
    if warming:
        # compile-ahead still running: membership suspends NEW dispatch
        # (not an outage — /healthz stays 200)
        doc["warming"] = warming
    return doc


def _fmt(value: float) -> str:
    """Prometheus number rendering: integral values without the '.0'."""
    if value != value:  # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _labels(names, values, extra: str = "") -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_text(registry: Optional[MetricsRegistry] = None,
                exemplars: bool = False) -> str:
    """The whole registry in Prometheus text exposition format.

    ``exemplars=True`` appends each bucket's retained exemplar in
    OpenMetrics syntax — ``... # {trace_id="<hex>"} <value> <ts>`` — so a
    scraped p99.9 bucket links straight to its flight-recorder trace
    (served at ``/metrics?exemplars=1``; default off, the plain 0.0.4
    parsers must keep working)."""
    registry = registry if registry is not None else REGISTRY
    lines = []
    for metric in registry.collect():
        if metric.help:
            lines.append(f"# HELP {metric.name} {_escape(metric.help)}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        for key, child in metric.children():
            if metric.kind == "histogram":
                cumulative, total_sum, count = child.snapshot()
                ex = child.exemplars() if exemplars else None
                for i, (bound, acc) in enumerate(cumulative):
                    le = _labels(metric.labelnames, key,
                                 extra=f'le="{_fmt(bound)}"')
                    line = f"{metric.name}_bucket{le} {acc}"
                    if ex is not None and ex[i] is not None:
                        tid, value, ts = ex[i]
                        line += (f' # {{trace_id="{tid:x}"}}'
                                 f" {_fmt(value)} {ts:.3f}")
                    lines.append(line)
                base = _labels(metric.labelnames, key)
                lines.append(f"{metric.name}_sum{base} {_fmt(total_sum)}")
                lines.append(f"{metric.name}_count{base} {count}")
            else:
                base = _labels(metric.labelnames, key)
                lines.append(f"{metric.name}{base} {_fmt(child.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


class MetricsServer:
    """Scrape endpoint on a stdlib threading HTTP server.

    ``port=0`` binds an ephemeral port (tests/CI); the bound port is
    readable at :attr:`port` after :meth:`start`.
    """

    def __init__(self, port: int = 9464, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None):
        self.host = host
        self.port = int(port)
        self.registry = registry if registry is not None else REGISTRY
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, body: bytes, content_type: str,
                       status: int = 200) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?")[0]
                query = self.path.partition("?")[2] or ""
                if path in ("/metrics", "/"):
                    # ?exemplars=1 opts into OpenMetrics exemplar
                    # suffixes (trace-id links); the default stays plain
                    # 0.0.4 for strict parsers
                    body = render_text(
                        registry, exemplars="exemplars=1" in query)
                    self._reply(body.encode("utf-8"), CONTENT_TYPE)
                elif path == "/alerts":
                    # the empty shell: no SLO engine in the port yet
                    body = json.dumps(alerts_document(), sort_keys=True,
                                      default=str).encode("utf-8")
                    self._reply(body, "application/json; charset=utf-8")
                elif path == "/healthz":
                    # JSON body: status + per-provider reasons, so fleet
                    # membership (and operators) read WHY — degraded is
                    # still 200 (serving, reduced capability), unhealthy
                    # is 503 (probes should pull the worker)
                    doc = health_document()
                    body = json.dumps(doc, sort_keys=True).encode("utf-8")
                    self._reply(body, "application/json; charset=utf-8",
                                status=200 if doc["status"] != "unhealthy"
                                else 503)
                elif path == "/stats.json":
                    # default=str: stats() snapshots may carry numpy
                    # scalars / deadline floats json can't serialize
                    doc = stats_snapshot()
                    doc["health"] = health_document()
                    body = json.dumps(doc, default=str,
                                      sort_keys=True).encode("utf-8")
                    self._reply(body, "application/json; charset=utf-8")
                elif path == "/profile":
                    self._profile(query)
                else:  # /trace.json included (not ported)
                    self.send_error(404)

            def _json(self, doc, status: int = 200) -> None:
                body = json.dumps(doc, sort_keys=True, default=str).encode("utf-8")
                self._reply(body, "application/json; charset=utf-8", status=status)

            def _profile(self, query: str) -> None:
                """One capture window on this handler's thread (the server
                is threading: scrapes go on), serialized process-wide."""
                from . import profiler

                params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
                try:
                    seconds = float(params["seconds"]) if "seconds" in params else None
                    frames = int(params["frames"]) if "frames" in params else None
                except ValueError:
                    self._json({"error": "bad_request",
                                "detail": f"unparseable query {query!r}"}, status=400)
                    return
                try:
                    summary = profiler.capture_profile(seconds=seconds, frames=frames,
                                                       trigger="http", registry=registry)
                except profiler.ProfileBusyError as exc:
                    self._json({"error": "busy", "active": exc.active}, status=409)
                except Exception as exc:  # noqa: BLE001 - a typed 500
                    self._json({"error": "capture_failed", "detail": repr(exc)}, status=500)
                else:
                    self._json(summary)

            def log_message(self, *args):  # silence per-scrape stderr spam
                del args

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="nnstpu-metrics",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


_server_lock = threading.Lock()
_server: Optional[MetricsServer] = None


def ensure_server(port: int, host: str = "127.0.0.1") -> MetricsServer:
    """Process-singleton scrape endpoint (conf-driven activation): the
    first caller binds, later callers get the running server — repeated
    ``pipeline.start()`` must not collide on the port."""
    global _server
    with _server_lock:
        if _server is None:
            _server = MetricsServer(port=port, host=host).start()
        return _server


def shutdown_server() -> None:
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None


def register_engine(engine, registry: Optional[MetricsRegistry] = None,
                    prefix: str = "nnstpu_serving"):
    """Republish a serving engine's ``stats()`` as gauges, refreshed at each
    scrape (its numeric and boolean fields; the per-slot map is left out).
    Returns the collector for :meth:`MetricsRegistry.remove_collector`."""
    registry = registry if registry is not None else REGISTRY

    def collect():
        for key, val in engine.stats().items():
            if isinstance(val, bool):
                val = int(val)
            if not isinstance(val, (int, float)):
                continue
            registry.gauge(f"{prefix}_{key}", f"serving engine stats() field {key!r}").set(val)

    return registry.add_collector(collect)
