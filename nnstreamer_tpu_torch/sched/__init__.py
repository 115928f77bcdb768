"""QoS scheduling & admission control for the serving front doors.

The port's copy of the JAX package's ``sched`` package (pure Python).
NNStreamer's pipeline paradigm pushes QoS into the dataflow layer (leaky
queues, ``tensor_rate``, sync policies); this package is the
request-level analog for the multi-tenant serving path
(``elements/query.py::QueryServer`` and ``serving.py::DecodeServer``):
without it one slow or floody client could starve every other stream, and
overload would mean queue growth and hangs instead of typed rejection.

- :mod:`.policy` — pluggable dispatch-order policies (``fifo``,
  ``prio``, ``edf``, ``drr`` weighted fairness);
- :mod:`.admission` — per-tenant bounded queues, token-bucket rate
  limits, deadline-expired drop, the :class:`PriorityGate` slot gate;
- :mod:`.breaker` — circuit breaker around backend invokes with
  half-open probing, and the weak registry of live breakers that the
  pipeline watchdog's overdue-device escalation trips (:func:`trip_all`);
- :class:`Scheduler` — the facade the servers hold: one object tying a
  policy + admission + breaker together, publishing ``nnstpu_sched_*``
  metrics on the observability registry (queue-wait histogram,
  shed/expired/breaker-trip counters, per-client deficit gauges).

Activation follows the tracer pattern: explicit ``scheduler=`` on the
server constructor wins; otherwise ``NNSTPU_SCHED_POLICY=drr`` (or the
ini ``[sched]`` section) builds one from conf — unset means no scheduler
and byte-identical legacy behavior.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..obs import spans as _spans
from .admission import (  # noqa: F401
    CODE_EXPIRED,
    CODE_OVERLOAD,
    CODE_UNAVAILABLE,
    AdmissionController,
    OverloadError,
    PriorityGate,
    TokenBucket,
)
from .breaker import (  # noqa: F401
    STATE_CODES,
    BreakerOpenError,
    CircuitBreaker,
    all_breakers,
    trip_all,
)
from .policy import (  # noqa: F401
    DrrPolicy,
    EdfPolicy,
    FifoPolicy,
    Policy,
    PriorityPolicy,
    SchedItem,
    make_policy,
    register_policy,
)

# Queue-wait buckets: a shed-don't-collapse server keeps waits in the
# low milliseconds; the tail matters up to the deadline scale.
QUEUE_WAIT_BUCKETS_MS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 10000.0,
)


class Scheduler:
    """Policy + admission + breaker behind one handle.

    Servers call, in order: :meth:`admit` at request receipt (may raise
    :class:`OverloadError` — reply the typed wire error and keep the
    connection), :meth:`enqueue`/:meth:`dequeue` around the dispatch
    decision, :meth:`expired_error` for items that outlived their
    deadline while queued, :meth:`invoke` around the backend call
    (breaker), and :meth:`release` when the request is finished either
    way.  ``stats()`` merges into the owning server's ``stats()``.
    """

    def __init__(
        self,
        policy="fifo",
        *,
        admission: Optional[AdmissionController] = None,
        breaker: Optional[CircuitBreaker] = None,
        name: str = "server",
        registry=None,
        quantum: float = 8.0,
        weights: Optional[Dict[str, float]] = None,
        priorities: Optional[Dict[str, int]] = None,
        priority_fn: Optional[Callable[[str], int]] = None,
        max_waiting: int = 16,
        clock: Callable[[], float] = time.monotonic,
    ):
        if isinstance(policy, str):
            policy = make_policy(policy, quantum=quantum, weights=weights)
        self.policy = policy
        self.admission = admission
        self.breaker = breaker
        self.name = str(name)
        self.priorities = dict(priorities or {})
        self.priority_fn = priority_fn
        self.gate = PriorityGate(max_waiting=max_waiting, clock=clock)
        self._clock = clock
        self._lock = threading.Lock()
        self.dispatched = 0
        self.expired = 0

        if registry is None:
            from ..obs.metrics import REGISTRY

            registry = REGISTRY
        self._registry = registry
        # queue-wait and shed/expired carry a ``tenant`` label so SLO
        # reports (tools/loadgen.py, dashboards) split per tenant straight
        # from the exposition instead of scraping stats JSON; tenant ""
        # is the unattributed bucket (no scheduler item in scope)
        self._m_wait = registry.histogram(
            "nnstpu_sched_queue_wait_ms",
            "admit-to-dispatch wait per scheduled request",
            labelnames=("server", "tenant"), buckets=QUEUE_WAIT_BUCKETS_MS)
        self._m_shed = registry.counter(
            "nnstpu_sched_shed_total",
            "requests shed by admission/deadline/breaker, by reason",
            labelnames=("server", "reason", "tenant"))
        self._m_expired = registry.counter(
            "nnstpu_sched_expired_total",
            "requests dropped because their deadline passed while queued",
            labelnames=("server", "tenant"))
        self._m_trips = registry.counter(
            "nnstpu_sched_breaker_trips_total",
            "circuit breaker closed/half-open -> open transitions",
            labelnames=("server",))
        self._m_dispatched = registry.counter(
            "nnstpu_sched_dispatched_total",
            "requests handed to the backend by the scheduler",
            labelnames=("server",))
        self._trips_seen = 0
        self._collector = registry.add_collector(self._collect)
        # structured snapshot in the merged /stats.json document (one
        # bound-method object kept: unregister matches by identity)
        from ..obs.export import register_stats

        self._stats_key = f"sched:{self.name}"
        self._stats_fn = self.stats
        register_stats(self._stats_key, self._stats_fn)

    # -- admission ----------------------------------------------------------

    def admit(self, client: str, tenant: Optional[str] = None,
              cost: float = 1.0, payload=None) -> SchedItem:
        """Admission-check one request; returns the stamped
        :class:`SchedItem` or raises :class:`OverloadError` (counted)."""
        tenant = tenant if tenant is not None else str(client)
        deadline = None
        if self.admission is not None:
            try:
                deadline = self.admission.try_admit(tenant, cost)
            except OverloadError as exc:
                self._m_shed.inc(server=self.name, reason=exc.reason,
                                 tenant=tenant)
                raise
        return SchedItem(client, cost=cost, tenant=tenant,
                         priority=self.priority_for(client),
                         deadline=deadline, enqueue_t=self._clock(),
                         payload=payload)

    def release(self, item: SchedItem) -> None:
        if self.admission is not None:
            self.admission.release(item.tenant)

    # -- queueing -----------------------------------------------------------

    def enqueue(self, item: SchedItem) -> None:
        with self._lock:
            self.policy.push(item)

    def dequeue(self) -> Optional[SchedItem]:
        with self._lock:
            item = self.policy.pop()
        if item is not None:
            self.dispatched += 1
            self._m_dispatched.inc(server=self.name)
        return item

    def queued(self) -> int:
        with self._lock:
            return len(self.policy)

    def observe_wait(self, item: SchedItem, now: Optional[float] = None,
                     trace: Optional[Tuple[int, int]] = None) -> None:
        now = now if now is not None else self._clock()
        waited_s = max(0.0, now - item.enqueue_t)
        self._m_wait.observe(waited_s * 1e3, server=self.name,
                             tenant=str(item.tenant or ""))
        if _spans.enabled:
            # the queue-wait interval as a span on the request's trace
            # (``trace`` from the caller, else the thread's current serve
            # span — the QueryServer direct path)
            end = _spans.now_ns()
            _spans.record_span(
                "sched_wait", end - int(waited_s * 1e9),
                int(waited_s * 1e9), cat="sched", trace=trace,
                args={"server": self.name, "client": item.client})

    def expired_error(self, item: SchedItem) -> OverloadError:
        """Count one deadline-expired drop and build its typed error."""
        self.expired += 1
        tenant = str(item.tenant or "")
        self._m_expired.inc(server=self.name, tenant=tenant)
        self._m_shed.inc(server=self.name, reason="expired", tenant=tenant)
        waited_ms = (self._clock() - item.enqueue_t) * 1e3
        return OverloadError(
            "expired",
            f"request from {item.client} expired after {waited_ms:.1f} ms "
            "queued (deadline passed before dispatch)",
            code=CODE_EXPIRED)

    # -- breaker ------------------------------------------------------------

    def invoke(self, fn: Callable[[], object], tenant: str = ""):
        """Run a backend invoke under the circuit breaker (if any); with
        span tracing on, the invoke (or the breaker rejection) is recorded
        on the calling thread's current trace.  ``tenant`` attributes a
        breaker-shed to the tenant whose request hit the open breaker."""
        t0 = _spans.now_ns() if _spans.enabled else 0
        try:
            if self.breaker is None:
                out = fn()
            else:
                out = self.breaker.call(fn)
        except BreakerOpenError:
            self._m_shed.inc(server=self.name, reason="breaker",
                             tenant=str(tenant or ""))
            if t0:
                _spans.record_span(
                    "breaker_open", t0, _spans.now_ns() - t0, cat="sched",
                    args={"server": self.name})
            raise
        except Exception:
            if t0:
                _spans.record_span(
                    "backend_invoke", t0, _spans.now_ns() - t0, cat="sched",
                    args={"server": self.name, "ok": False})
            raise
        if t0:
            _spans.record_span(
                "backend_invoke", t0, _spans.now_ns() - t0, cat="sched",
                args={"server": self.name, "ok": True})
        return out

    # -- slot assignment (DecodeServer) -------------------------------------

    def priority_for(self, client: str) -> int:
        if self.priority_fn is not None:
            return int(self.priority_fn(client))
        if client in self.priorities:
            return int(self.priorities[client])
        # fall back to the host-level entry for ip:port clients
        host = client.rsplit(":", 1)[0]
        return int(self.priorities.get(host, 0))

    def acquire_slot(self, client: str, try_grant: Callable[[], object],
                     timeout: Optional[float] = None,
                     tenant: Optional[str] = None):
        """Priority-ordered, bounded wait for a contended slot.  The
        tenant defaults to the client's host part (the same fallback the
        servers apply when no wire identity was declared)."""
        if tenant is None:
            tenant = client.rsplit(":", 1)[0]
        try:
            return self.gate.acquire(self.priority_for(client), try_grant,
                                     timeout=timeout)
        except OverloadError as exc:
            self._m_shed.inc(server=self.name, reason=exc.reason,
                             tenant=str(tenant or ""))
            raise

    # -- observability ------------------------------------------------------

    def _collect(self) -> None:
        """Scrape-time gauges: queue depth, breaker state, DRR deficits."""
        reg = self._registry
        reg.gauge("nnstpu_sched_queued",
                  "schedulable items currently queued",
                  labelnames=("server",)).set(self.queued(), server=self.name)
        if self.breaker is not None:
            st = self.breaker.stats()
            reg.gauge("nnstpu_sched_breaker_state",
                      "0=closed 1=half_open 2=open",
                      labelnames=("server",)).set(
                STATE_CODES[st["state"]], server=self.name)
            if st["trips"] > self._trips_seen:
                self._m_trips.inc(st["trips"] - self._trips_seen,
                                  server=self.name)
                self._trips_seen = st["trips"]
        with self._lock:
            deficits = self.policy.deficits()
        if deficits:
            g = reg.gauge("nnstpu_sched_client_deficit",
                          "DRR per-client deficit credit",
                          labelnames=("server", "client"))
            for client, d in deficits.items():
                g.set(d, server=self.name, client=client)

    def stats(self) -> dict:
        out = {
            "name": self.name,
            "dispatched": self.dispatched,
            "expired": self.expired,
            "queued": self.queued(),
        }
        with self._lock:
            out.update(self.policy.stats())
        if self.admission is not None:
            out["admission"] = self.admission.stats()
        if self.breaker is not None:
            out["breaker"] = self.breaker.stats()
        gs = self.gate.stats()
        if gs["granted"] or gs["waiting"] or gs["shed_full"]:
            out["slot_gate"] = gs
        return out

    def close(self) -> None:
        """Detach the scrape collector + stats provider (idempotent)."""
        self._registry.remove_collector(self._collector)
        from ..obs.export import unregister_stats

        unregister_stats(self._stats_key, self._stats_fn)


def _parse_kv_ints(spec: str) -> Dict[str, int]:
    """``"10.0.0.5=10,cli-a=2"`` → {"10.0.0.5": 10, "cli-a": 2}."""
    out: Dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        out[key.strip()] = int(val.strip() or 0)
    return out


def from_conf(name: str = "server", conf=None, registry=None,
              ) -> Optional[Scheduler]:
    """Build a :class:`Scheduler` from the ``[sched]`` conf section
    (``NNSTPU_SCHED_*`` env over ini over defaults — the tracer
    activation pattern).  Returns ``None`` when no policy is configured,
    which keeps every server byte-identical to pre-scheduler behavior."""
    if conf is None:
        from ..conf import conf as conf_
        conf = conf_
    policy = (conf.get("sched", "policy", "") or "").strip().lower()
    if not policy:
        return None
    max_queue = conf.get_int("sched", "max_queue_per_client", 64)
    rate = conf.get_float("sched", "rate", 0.0)
    burst = conf.get_float("sched", "burst", 0.0)
    deadline_ms = conf.get_float("sched", "deadline_ms", 0.0)
    admission = None
    if max_queue or rate > 0 or deadline_ms > 0:
        admission = AdmissionController(
            max_queue=max_queue or 64, rate=rate, burst=burst,
            deadline_ms=deadline_ms)
    breaker = None
    failures = conf.get_int("sched", "breaker_failures", 0)
    if failures > 0:
        breaker = CircuitBreaker(
            failure_threshold=failures,
            reset_timeout_s=conf.get_float("sched", "breaker_reset_s", 30.0))
    return Scheduler(
        policy,
        admission=admission,
        breaker=breaker,
        name=name,
        registry=registry,
        quantum=conf.get_float("sched", "quantum", 8.0),
        priorities=_parse_kv_ints(conf.get("sched", "priorities", "") or ""),
        max_waiting=conf.get_int("sched", "max_waiting", 16),
    )


# the spelling the servers use at construction (tracer-pattern activation)
configured_scheduler = from_conf
