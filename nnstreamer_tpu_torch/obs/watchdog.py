"""Pipeline health watchdog: stalled sources, wedged queues, overdue
device dispatches.

The port's copy of the JAX package's ``obs/watchdog.py``.  A streaming
pipeline fails silent more often than it fails loud: a source that blocks
in its own iterator, a queue whose consumer wedged (a deadlocked chain
downstream, a backend stuck on a sick card), a device dispatch that never
completes.  None of those post an error: the graph just stops moving.  The
watchdog (``NNSTPU_TRACERS=watchdog`` or ``pipeline.attach_tracer("watchdog")``)
makes "stopped moving" a state one can observe:

- a monitor thread (``watchdog:<pipeline>``) ticks every ``[obs]
  watchdog_interval`` seconds and checks the pipeline for **stalled
  sources** (executing, in thread mode its thread alive and under the
  dispatcher lanes its task mid-slice or its helper alive, but no
  ``source_push`` within ``watchdog_stall_s``), **wedged queues** (depth at
  or above ``watchdog_queue_depth`` with no pop for the stall window) and
  **overdue device work** (a dispatch whose completion the ``device``
  tracer (:class:`~.device.DeviceTracer`) has not observed within
  ``watchdog_device_deadline_s``; without that tracer nothing is in flight
  and the check is silent);
- an unhealthy verdict flips the pipeline's health: the ``nnstpu_health``
  gauge drops to 0, ``/healthz`` on the metrics server answers 503 with
  the reasons (:func:`~.export.register_health`), the ``health`` hook
  fires, an instant lands in the flight recorder, each reason's kind
  counts in ``nnstpu_watchdog_stalls_total``, and the pipeline writes a
  flight dump (``{name}.stall.trace.json`` in ``[obs] flight_dump_dir``),
  the black box ``post_error`` writes, for hangs instead of crashes;
- recovery (frames moving again) flips everything back and fires the hook
  again, so flapping shows too;
- with ``recover=True`` (``[obs] watchdog_recover``) a verdict escalates
  to **self-healing**: restart the stalled source
  (:meth:`Pipeline.restart_source`), drain the wedged queue
  (:meth:`Pipeline.recover_queue`), trip every live circuit breaker for an
  overdue device (:func:`nnstreamer_tpu_torch.sched.breaker.trip_all`,
  recorded as ``breaker_trip``); at most ``watchdog_recover_budget``
  attempts per (kind, target) while unhealthy, each counted in
  ``nnstpu_recovery_total{action,result}``.

A posted pipeline error also marks the pipeline unhealthy: a crashed
graph never answers ``/healthz`` with 200.

With ``[obs] watchdog_wire_probe_s`` > 0 the monitor probes the local
host-to-device wire on that cadence and publishes it
(:func:`~.util.probe_wire_health`, :func:`~.util.publish_wire_health`);
:meth:`PipelineWatchdog.summary` carries the last reading.  On the same
cadence it runs every registered partition edge's prober
(:func:`~.util.register_wire_edge`) and publishes under the edge's address,
so a flip of an edge's regime reaches the repartition monitor.

With ``[obs] profile_auto`` on, a :class:`~.profiler.DegradeDetector` on
``device_exec`` (the ``device`` tracer's completions) watches each
capture's device time, and when a dispatch leaves the noise band the
monitor starts one deep-profiling capture in the background
(``trigger="watchdog"``, ``[obs] profile_auto_seconds`` long), at most one
per ``profile_auto_cooldown_s``; a capture already running (a typed
:class:`~.profiler.ProfileBusyError`) is skipped, not raised.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from . import spans
from .export import register_health, unregister_health
from .metrics import MetricsRegistry
from .tracers import Tracer

now_ns = time.perf_counter_ns

_LOG = logging.getLogger("nnstreamer_tpu_torch.obs")

DEFAULT_INTERVAL_S = 1.0
DEFAULT_STALL_S = 5.0
DEFAULT_QUEUE_DEPTH = 1
DEFAULT_DEVICE_DEADLINE_S = 30.0
DEFAULT_RECOVER_BUDGET = 3


class PipelineWatchdog(Tracer):
    name = "watchdog"

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_s: Optional[float] = None,
                 stall_s: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 device_deadline_s: Optional[float] = None,
                 recover: Optional[bool] = None,
                 recover_budget: Optional[int] = None):
        """A None argument is read from the conf (``[obs] watchdog_*``) at
        each start.  ``recover=True`` escalates a verdict into recovery; at
        most ``recover_budget`` attempts per (kind, target) while
        unhealthy, and the budgets reset when health returns, so a flapping
        target can be rescued again but never restart-stormed."""
        super().__init__(registry)
        self._interval = interval_s
        self._stall = stall_s
        self._depth_threshold = queue_depth
        self._device_deadline = device_deadline_s
        self._recover = recover
        self._recover_budget = recover_budget
        self._recover_attempts: Dict[tuple, int] = {}
        self._recoveries = 0
        self._lock = threading.Lock()
        self._src_last: Dict[str, int] = {}       # source -> last push ts_ns
        self._q_state: Dict[str, List[int]] = {}  # queue -> [depth, last pop ts_ns]
        self._healthy = True
        self._reasons: List[str] = []
        self._checks = 0
        self._transitions = 0
        self._stop_evt = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._health_fn = None
        self._wire_probe_s = 0.0
        self._last_wire_probe = 0.0
        # [obs] profile_auto: read at each start
        self._profile_auto = False
        self._profile_detector = None
        self._profile_auto_s = 1.0
        self._profile_cooldown_s = 120.0
        self._last_auto_profile: Optional[float] = None  # no capture yet
        self._auto_captures = 0

    # -- lifecycle -----------------------------------------------------------

    @staticmethod
    def _conf_value(getter, key: str, default):
        try:
            return getter("obs", key, default)
        except ValueError:
            return default

    def _install(self) -> None:
        from ..conf import conf

        if self._interval is None:
            self._interval = self._conf_value(conf.get_float, "watchdog_interval",
                                              DEFAULT_INTERVAL_S)
        if self._stall is None:
            self._stall = self._conf_value(conf.get_float, "watchdog_stall_s", DEFAULT_STALL_S)
        if self._depth_threshold is None:
            self._depth_threshold = self._conf_value(conf.get_int, "watchdog_queue_depth",
                                                     DEFAULT_QUEUE_DEPTH)
        if self._device_deadline is None:
            self._device_deadline = self._conf_value(
                conf.get_float, "watchdog_device_deadline_s", DEFAULT_DEVICE_DEADLINE_S)
        if self._recover is None:
            self._recover = self._conf_value(conf.get_bool, "watchdog_recover", False)
        if self._recover_budget is None:
            self._recover_budget = self._conf_value(conf.get_int, "watchdog_recover_budget",
                                                    DEFAULT_RECOVER_BUDGET)
        # > 0: probe the host-to-device wire this often and publish it (the
        # nnstpu_wire_* gauges of obs/util.py), so a slow wire shows on
        # /metrics while the pipeline runs
        self._wire_probe_s = self._conf_value(conf.get_float, "watchdog_wire_probe_s", 0.0)
        self._last_wire_probe = 0.0
        # [obs] profile_auto: when a dispatch's device time degrades beyond
        # the noise band, start a deep-profiling capture (obs/profiler.py)
        # while the regression is still happening, at most one a cooldown
        self._profile_auto_s = self._conf_value(conf.get_float, "profile_auto_seconds", 1.0)
        self._profile_cooldown_s = self._conf_value(conf.get_float, "profile_auto_cooldown_s",
                                                    120.0)
        self._last_auto_profile = None
        self._profile_auto = self._conf_value(conf.get_bool, "profile_auto", False)
        self._profile_detector = None
        if self._profile_auto:
            from .profiler import DegradeDetector

            self._profile_detector = DegradeDetector()
            self._connect("device_exec", self._profile_detector.on_device_exec)
        self._gauge = self._registry.gauge(
            "nnstpu_health",
            "Pipeline health as judged by the watchdog (1 healthy, 0 unhealthy)",
            labelnames=("pipeline",),
        )
        self._stall_counter = self._registry.counter(
            "nnstpu_watchdog_stalls_total",
            "Health flips to unhealthy, by reason kind",
            labelnames=("pipeline", "kind"),
        )
        self._gauge.set(1, pipeline=self._pipeline.name)
        # health instants and stall dumps need the flight recorder, even
        # when the watchdog is the only tracer attached
        spans._activate(spans.configured_flight_records())
        self._connect("source_spawn", self._on_source_spawn)
        self._connect("source_push", self._on_source_push)
        self._connect("queue_push", self._on_queue_push)
        self._connect("queue_pop", self._on_queue_pop)
        self._connect("error", self._on_error)
        # hold one bound method: unregister compares by identity, and each
        # access of self.health makes a new one
        self._health_fn = self.health
        register_health(self._pipeline.name, self._health_fn)
        self._stop_evt.clear()
        self._monitor = threading.Thread(target=self._run,
                                         name=f"watchdog:{self._pipeline.name}", daemon=True)
        self._monitor.start()

    def stop(self) -> None:
        was_active = bool(self._conns)
        super().stop()
        if not was_active:
            return
        self._stop_evt.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
            self._monitor = None
        unregister_health(self._pipeline.name, self._health_fn)
        spans._deactivate()

    # -- hook callbacks ------------------------------------------------------

    def _on_source_spawn(self, pipeline, node) -> None:
        if pipeline is self._pipeline:
            with self._lock:
                self._src_last[node.name] = now_ns()

    def _on_source_push(self, pipeline, node, frame) -> None:
        del frame
        if pipeline is self._pipeline:
            with self._lock:
                self._src_last[node.name] = now_ns()

    def _on_queue_push(self, node, depth) -> None:
        if node.pipeline is self._pipeline:
            with self._lock:
                st = self._q_state.setdefault(node.name, [0, now_ns()])
                st[0] = depth

    def _on_queue_pop(self, node, depth) -> None:
        if node.pipeline is self._pipeline:
            with self._lock:
                self._q_state[node.name] = [depth, now_ns()]

    def _on_error(self, pipeline, node, exc) -> None:
        if pipeline is self._pipeline:
            # post_error wrote its own flight dump
            self._flip([f"error:{node.name if node else '?'}: {exc!r}"], dump=False)

    # -- the monitor ---------------------------------------------------------

    def _evaluate(self) -> List[str]:
        now = now_ns()
        stall_ns = int(self._stall * 1e9)
        reasons: List[str] = []
        with self._lock:
            src = dict(self._src_last)
            queues = {k: list(v) for k, v in self._q_state.items()}
        for name, last in src.items():
            # the pipeline knows the substrate: a streaming thread, or a
            # lane task and its helper
            if now - last > stall_ns and self._pipeline.source_alive(name):
                reasons.append(f"stalled_source:{name}: no frame for "
                               f"{(now - last) / 1e9:.1f}s")
        for name, (depth, last_pop) in queues.items():
            if depth >= self._depth_threshold and now - last_pop > stall_ns:
                reasons.append(f"wedged_queue:{name}: depth {depth}, no pop for "
                               f"{(now - last_pop) / 1e9:.1f}s")
        from .device import oldest_inflight

        oldest = oldest_inflight()
        if oldest is not None:
            t0, element = oldest
            age = (now - t0) / 1e9
            if age > self._device_deadline:
                reasons.append(f"overdue_device:{element}: dispatch executing for {age:.1f}s")
        return reasons

    def _probe_wire(self) -> None:
        """The local wire's probe and every registered edge's on their
        cadence; a failed probe never flags health nor ends the monitor."""
        if self._wire_probe_s <= 0 or \
                time.monotonic() - self._last_wire_probe < self._wire_probe_s:
            return
        self._last_wire_probe = time.monotonic()
        from . import util as _util

        try:
            _util.publish_wire_health(_util.probe_wire_health(n=4), self._registry)
        except Exception:  # noqa: BLE001 - a probe is best-effort
            pass
        # partition edges re-probe on the same cadence: an edge's regime flip
        # is what triggers repartitioning, so it is observed, not polled
        for addr, prober in _util.wire_edges().items():
            try:
                _util.publish_wire_health(prober(), self._registry, addr=addr)
            except Exception:  # noqa: BLE001 - a dead edge is the deployer's
                pass

    def _run(self) -> None:
        while not self._stop_evt.wait(self._interval):
            if self._pipeline.state != "PLAYING":
                continue
            with self._lock:
                self._checks += 1
            self._probe_wire()
            if self._profile_detector is not None:
                verdict = self._profile_detector.degraded()
                # the first verdict always captures (the JAX package starts
                # its cooldown clock at 0, which on a host up for less than
                # the cooldown skips the first one)
                if verdict and (self._last_auto_profile is None or time.monotonic()
                                - self._last_auto_profile >= self._profile_cooldown_s):
                    self._last_auto_profile = time.monotonic()
                    self._auto_capture(verdict)
            try:
                reasons = self._evaluate()
            except Exception:  # noqa: BLE001 - the monitor survives
                _LOG.exception("watchdog evaluation failed")
                continue
            if reasons:
                self._flip(reasons)
                if self._recover:
                    try:
                        self._attempt_recovery(reasons)
                    except Exception:  # noqa: BLE001 - the monitor survives
                        _LOG.exception("watchdog recovery failed")
            else:
                self._recovered()

    def _auto_capture(self, verdict: str) -> None:
        """One watchdog-triggered capture, on a thread of its own (the
        monitor's tick must not block for the window); a capture already
        running skips it, the cooldown stamped either way."""
        _LOG.warning("watchdog: device-time degradation (%s); starting a profile capture",
                     verdict)

        def run():
            from . import profiler

            try:
                profiler.capture_profile(seconds=self._profile_auto_s, pipeline=self._pipeline,
                                         trigger="watchdog", registry=self._registry)
                with self._lock:
                    self._auto_captures += 1
            except profiler.ProfileBusyError:
                pass
            except Exception:  # noqa: BLE001 - the capture is best-effort
                _LOG.exception("watchdog auto-capture failed")

        threading.Thread(target=run, daemon=True,
                         name=f"wd-profile:{self._pipeline.name}").start()

    def _flip(self, reasons: List[str], dump: bool = True) -> None:
        with self._lock:
            first = self._healthy
            self._healthy = False
            self._reasons = list(reasons)
            if first:
                self._transitions += 1
        if not first:
            return
        from . import hooks as _hooks

        name = self._pipeline.name
        _LOG.warning("watchdog: pipeline %r unhealthy: %s", name, "; ".join(reasons))
        self._gauge.set(0, pipeline=name)
        for r in reasons:
            self._stall_counter.inc(1, pipeline=name, kind=r.split(":", 1)[0])
        spans.record_instant("watchdog_unhealthy", cat="health", trace=(0, 0),
                             args={"reasons": reasons})
        if _hooks.enabled:
            _hooks.emit("health", self._pipeline, False, "; ".join(reasons))
        if dump:
            # the black box post_error writes, for a hang
            self._pipeline._dump_flight("stall")

    def _attempt_recovery(self, reasons: List[str]) -> None:
        """Escalation: one recovery action per unhealthy reason, capped per
        (kind, target).  The pipeline's recovery methods record their
        outcomes on ``nnstpu_recovery_total``; the breaker trip records its
        own."""
        from . import recovery as _recovery

        for r in reasons:
            kind, _, rest = r.partition(":")
            target = rest.partition(":")[0]
            key = (kind, target)
            with self._lock:
                attempts = self._recover_attempts.get(key, 0)
                if attempts >= self._recover_budget:
                    continue
                self._recover_attempts[key] = attempts + 1
                self._recoveries += 1
            if kind == "stalled_source":
                self._pipeline.restart_source(target)
            elif kind == "wedged_queue":
                self._pipeline.recover_queue(target)
            elif kind == "overdue_device":
                from ..sched.breaker import trip_all

                n = trip_all(reason=r)
                _recovery.record(self._pipeline.name, "breaker_trip", "ok" if n else "error",
                                 target, f"tripped={n}")

    def _recovered(self) -> None:
        with self._lock:
            if self._healthy:
                return
            self._healthy = True
            self._reasons = []
            self._transitions += 1
            # fresh budgets: a later wedge of the same target may be
            # rescued again (the flaps stay in _transitions)
            self._recover_attempts.clear()
        from . import hooks as _hooks

        self._gauge.set(1, pipeline=self._pipeline.name)
        spans.record_instant("watchdog_recovered", cat="health", trace=(0, 0), args=None)
        if _hooks.enabled:
            _hooks.emit("health", self._pipeline, True, "")

    # -- readouts ------------------------------------------------------------

    def health(self):
        """(healthy, reason): the ``/healthz`` provider contract."""
        with self._lock:
            return self._healthy, "; ".join(self._reasons)

    def summary(self) -> dict:
        from .export import degraded_snapshot
        from .util import last_wire_health

        with self._lock:
            out = {
                "healthy": self._healthy,
                "reasons": list(self._reasons),
                "checks": self._checks,
                "transitions": self._transitions,
                "sources": len(self._src_last),
                "queues": len(self._q_state),
                "recover": bool(self._recover),
                "recoveries": self._recoveries,
            }
            if self._profile_auto:
                out["profile_auto"] = {
                    "captures": self._auto_captures,
                    "verdicts": (self._profile_detector.verdicts
                                 if self._profile_detector else 0),
                }
        # degraded-but-serving reasons ride along, so a stats.json reader
        # sees them beside the verdict without scraping /healthz
        degraded = degraded_snapshot()
        if degraded:
            out["degraded"] = degraded
        # the last published wire probe (the watchdog's or another's)
        wire = last_wire_health()
        if wire is not None:
            out["wire"] = wire
        return out


from .tracers import TRACERS  # noqa: E402

TRACERS[PipelineWatchdog.name] = PipelineWatchdog
