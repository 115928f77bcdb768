"""Fleet membership: who is alive, who is degraded, who gets traffic.

The port of the JAX package's ``fleet/membership.py``: the same states,
the same verdicts on the same probe answers and the same per-worker
breakers, so a roster driven by explicit :meth:`Membership.sweep` calls
walks through the same states in both packages.

The router never guesses about a worker — this layer owns the verdict,
fed by three signals:

- **heartbeats**: a monitor thread probes every worker's ``/healthz``
  (the JSON body from :func:`nnstreamer_tpu_torch.obs.export.health_document`)
  each ``[fleet] heartbeat_s``.  ``ok`` keeps a worker UP, ``degraded``
  (a reason a worker or its scheduler publishes) deprioritizes it — degraded workers are
  only picked when no fully-healthy worker is eligible — and
  ``unhealthy`` (a watchdog 503) removes it from rotation without
  ejecting it;
- **missed heartbeats**: ``suspect_misses`` consecutive misses mark a
  worker SUSPECT — no NEW dispatches, but nothing in flight is touched
  and no sessions are broken, because a heartbeat partition is not a
  crash (the disambiguation the failover tests pin: a suspect worker
  whose data path still answers must not cause duplicate dispatch);
  ``death_misses`` misses mark it DOWN (ejected).  A DOWN worker whose
  probe answers again is revived with a fresh breaker — kill/restart
  churn converges without operator action;
- **data-path reports**: the router reports every forward outcome.
  Failures feed a per-worker :class:`~nnstreamer_tpu_torch.sched.breaker.
  CircuitBreaker`, so a flapping worker is quarantined (picks skip it)
  until the half-open probe proves it back.

Draining is orthogonal to health: :meth:`Membership.drain` takes a
worker out of ALL selection (new sessions and stateless traffic) while
its live sessions finish — the router's ``drain_worker`` waits for
those, then calls :meth:`eject` (planned removal, the rebalance story).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from ..sched.breaker import BreakerOpenError, CircuitBreaker

UP = "up"
DEGRADED = "degraded"
UNHEALTHY = "unhealthy"
SUSPECT = "suspect"
DOWN = "down"
# compile-ahead warmup in progress: suspend-dispatch, NOT unhealthy —
# the worker is alive and converging; routing to it would serve requests
# into cold executables (exactly what warmup exists to prevent)
WARMING = "warming"
# the worker itself reported a graceful drain in progress (SIGTERM):
# no new dispatch or sessions, existing sessions still flow — and the
# stateful router's migration monitor treats this as the signal to move
# the worker's live decode sessions elsewhere before the drain deadline
# force-breaks them
DRAINING = "draining"
# registered by a supervisor's spawn, and no probe of this incarnation has
# answered yet: out of every pick and not joinable.  The JAX package reads
# such an entry up (ROADMAP C22): a router could dispatch into a worker
# still capturing, and a supervision pass before any sweep joined it.
UNPROBED = "unprobed"

# numeric encoding for the state gauge (Prometheus can't label strings)
STATE_CODES = {UP: 0, DEGRADED: 1, UNHEALTHY: 2, SUSPECT: 3, DOWN: 4,
               WARMING: 5, DRAINING: 6, UNPROBED: 7}


class NoWorkerAvailable(RuntimeError):
    """No eligible worker: every member is down, draining, quarantined,
    or excluded.  The router turns this into a typed ``[UNAVAILABLE]``
    wire error."""


class WorkerInfo:
    """One fleet member: address, probe channel, health verdict, and the
    per-worker breaker.  ``block_health`` / ``block_data`` are the chaos
    partition knobs (a partitioned worker is unreachable, not dead)."""

    def __init__(self, worker_id: str, host: str, port: int,
                 health_addr: Optional[str] = None,
                 probe: Optional[Callable[["WorkerInfo"], str]] = None,
                 breaker_failures: int = 3, breaker_reset_s: float = 2.0,
                 assume_up: bool = True):
        self.id = worker_id
        self.host, self.port = host, int(port)
        self.health_addr = health_addr  # "host:port" of the metrics server
        self.probe = probe              # overrides the HTTP prober (tests)
        self.state = UP if assume_up else UNPROBED
        self.draining = False
        self.misses = 0
        self.degraded_reason = ""
        # incarnation witness: probes may report a per-process start
        # nonce (the /healthz "nonce" key, or the second element of a
        # (status, nonce) probe return).  Per-worker failure state —
        # breaker, miss streak, draining — is keyed by (address, nonce):
        # a respawned process must not inherit its dead predecessor's
        # quarantine, whatever address it came back on.
        self.incarnation: Optional[str] = None
        # bumped on every rebind: consumers holding per-worker resources
        # keyed by this object (the router's connection pools) must
        # discard them when the generation moves — pooled sockets to the
        # dead incarnation's address are not connections to this worker
        self.generation = 0
        self.last_seen = time.monotonic()
        self.block_health = False       # chaos: heartbeat channel cut
        self.block_data = False         # chaos: data path cut
        # sessions currently mid-handoff OFF this worker (router-owned):
        # drain accounting counts them as migrating, not live — an
        # operator watching a drain sees progress, not a stuck count
        self.sessions_migrating = 0
        self._breaker_cfg = (int(breaker_failures), float(breaker_reset_s))
        self.breaker = CircuitBreaker(
            failure_threshold=self._breaker_cfg[0],
            reset_timeout_s=self._breaker_cfg[1])
        # data-path accounting (router-reported)
        self.routed = 0
        self.failures = 0
        self.revivals = 0

    @property
    def addr(self):
        return (self.host, self.port)

    def reset_breaker(self) -> None:
        """Fresh breaker on revival: a restarted worker does not inherit
        its predecessor's failure streak."""
        self.breaker = CircuitBreaker(
            failure_threshold=self._breaker_cfg[0],
            reset_timeout_s=self._breaker_cfg[1])

    def rebind(self, host: str, port: int,
               health_addr: Optional[str] = None,
               probe: Optional[Callable[["WorkerInfo"], str]] = None
               ) -> None:
        """Move this roster entry to a NEW incarnation's address (a
        supervisor respawned the worker, possibly on different ports):
        fresh breaker, cleared miss/suspect/draining state — nothing of
        the dead incarnation survives but the id and its counters."""
        self.host, self.port = host, int(port)
        if health_addr is not None:
            self.health_addr = health_addr
        if probe is not None:
            self.probe = probe
        self.generation += 1
        if self.state != DOWN:
            # no probe of the new incarnation yet (a DOWN entry stays DOWN,
            # out of selection too, and its next answer counts a revival)
            self.state = UNPROBED
        self.reset_breaker()
        self.misses = 0
        self.draining = False
        self.degraded_reason = ""
        self.incarnation = None  # learned from the next probe
        self.block_health = False
        self.block_data = False

    def snapshot(self) -> dict:
        return {
            "id": self.id,
            "addr": f"{self.host}:{self.port}",
            "state": self.state,
            "draining": self.draining,
            "misses": self.misses,
            "degraded_reason": self.degraded_reason,
            "breaker": self.breaker.stats()["state"],
            "incarnation": self.incarnation,
            "routed": self.routed,
            "failures": self.failures,
            "revivals": self.revivals,
            "sessions_migrating": self.sessions_migrating,
        }


def _http_probe(worker: WorkerInfo, timeout_s: float):
    """Default prober: GET the worker's ``/healthz`` and map the JSON
    body to ``(status string, incarnation nonce or None)``; raising =
    unreachable (a miss)."""
    if worker.health_addr is None:
        raise ConnectionError(f"{worker.id}: no health address")
    url = f"http://{worker.health_addr}/healthz"
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            body = resp.read()
    except urllib.error.HTTPError as exc:
        if exc.code == 503:
            # a SIGTERM-draining worker answers 503 with its reason in
            # the JSON body: surface DRAINING (the migration monitor's
            # signal) instead of a bare UNHEALTHY
            try:
                doc = json.loads(exc.read().decode("utf-8"))
                fails = doc.get("failures") or {}
                if any("draining" in str(v) for v in fails.values()):
                    return DRAINING, doc.get("nonce")
            except (ValueError, AttributeError, OSError):
                pass
            return UNHEALTHY, None
        raise
    try:
        doc = json.loads(body.decode("utf-8"))
        status = str(doc.get("status", "ok"))
        nonce = doc.get("nonce")
        if status == "degraded":
            # carry WHY, so operators see the deprioritization reason in
            # the roster
            reasons = "; ".join(
                f"{k}: {v}" for k, v in sorted(
                    (doc.get("degraded") or {}).items()))
            return f"degraded:{reasons}", nonce
        if status == "warming":
            reasons = "; ".join(
                f"{k}: {v}" for k, v in sorted(
                    (doc.get("warming") or {}).items()))
            return f"warming:{reasons}", nonce
        return status, nonce
    except (ValueError, AttributeError):
        return "ok", None  # pre-JSON peer: 200 means serving


class Membership:
    """Tracks the fleet; the router asks it :meth:`pick` per dispatch."""

    def __init__(self, heartbeat_s: Optional[float] = None,
                 probe_timeout_s: Optional[float] = None,
                 suspect_misses: Optional[int] = None,
                 death_misses: Optional[int] = None,
                 breaker_failures: Optional[int] = None,
                 breaker_reset_s: Optional[float] = None,
                 registry=None):
        from ..conf import conf

        def _f(key, arg, default):
            return float(arg) if arg is not None else \
                conf.get_float("fleet", key, default)

        def _i(key, arg, default):
            return int(arg) if arg is not None else \
                conf.get_int("fleet", key, default)

        self.heartbeat_s = _f("heartbeat_s", heartbeat_s, 0.5)
        self.probe_timeout_s = _f("probe_timeout_s", probe_timeout_s, 2.0)
        self.suspect_misses = _i("suspect_misses", suspect_misses, 2)
        self.death_misses = _i("death_misses", death_misses, 6)
        self._breaker_failures = _i("breaker_failures", breaker_failures, 3)
        self._breaker_reset_s = _f("breaker_reset_s", breaker_reset_s, 2.0)
        self._lock = threading.Lock()
        self._workers: Dict[str, WorkerInfo] = {}
        self._rr = 0  # round-robin cursor
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sweeps = 0
        self.quarantine_skips = 0  # picks that skipped an open breaker
        if registry is None:
            from ..obs.metrics import REGISTRY

            registry = REGISTRY
        self._g_state = registry.gauge(
            "nnstpu_fleet_worker_state",
            "fleet worker state (0=up 1=degraded 2=unhealthy 3=suspect "
            "4=down 5=warming 6=draining 7=unprobed)", labelnames=("worker",))
        self._c_misses = registry.counter(
            "nnstpu_fleet_probe_misses_total",
            "missed membership heartbeats", labelnames=("worker",))

    # -- roster --------------------------------------------------------------

    def add(self, host: str, port: int, health_addr: Optional[str] = None,
            probe: Optional[Callable[[WorkerInfo], str]] = None,
            worker_id: Optional[str] = None,
            assume_up: bool = True) -> WorkerInfo:
        """Register a worker.  ``probe`` overrides the HTTP ``/healthz``
        prober (in-process fleets / tests); ``health_addr`` is the
        worker's metrics-server ``host:port``.  A static roster entry (an
        operator's ``--workers``) is assumed up until its first probe says
        otherwise, as in the JAX package; a worker just spawned is not:
        ``assume_up=False`` keeps it :data:`UNPROBED` — no pick, no join —
        until a probe answers."""
        w = WorkerInfo(worker_id or f"{host}:{port}", host, port,
                       health_addr=health_addr, probe=probe,
                       breaker_failures=self._breaker_failures,
                       breaker_reset_s=self._breaker_reset_s,
                       assume_up=assume_up)
        with self._lock:
            self._workers[w.id] = w
        self._g_state.set(STATE_CODES[w.state], worker=w.id)
        return w

    def remove(self, worker_id: str) -> None:
        with self._lock:
            self._workers.pop(worker_id, None)

    def rebind(self, worker_id: str, host: str, port: int,
               health_addr: Optional[str] = None,
               probe: Optional[Callable[[WorkerInfo], str]] = None
               ) -> WorkerInfo:
        """Point an existing roster entry at a respawned incarnation —
        possibly on a *different* address (ephemeral ports).  The entry
        keeps its id and traffic counters but none of the dead
        incarnation's failure state (breaker, misses, draining); the
        next probe's verdict (with the new nonce) brings it back into
        rotation.  Unknown ids fall through to :meth:`add` so a
        supervisor can use one call for both paths."""
        with self._lock:
            w = self._workers.get(worker_id)
        if w is None:
            return self.add(host, port, health_addr=health_addr,
                            probe=probe, worker_id=worker_id, assume_up=False)
        w.rebind(host, port, health_addr=health_addr, probe=probe)
        self._g_state.set(STATE_CODES[w.state], worker=w.id)
        return w

    def get(self, worker_id: str) -> WorkerInfo:
        with self._lock:
            return self._workers[worker_id]

    def workers(self) -> List[WorkerInfo]:
        with self._lock:
            return list(self._workers.values())

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Membership":
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-membership", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "Membership":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.heartbeat_s):
            try:
                self.sweep()
            except Exception:  # noqa: BLE001 — the monitor must survive
                import logging

                logging.getLogger("nnstreamer_tpu_torch.fleet").exception(
                    "membership sweep failed")

    # -- heartbeats ----------------------------------------------------------

    def sweep(self) -> None:
        """One heartbeat pass over the whole roster (callable directly
        from tests for deterministic convergence)."""
        self.sweeps += 1
        for w in self.workers():
            try:
                if w.block_health:
                    raise ConnectionError(f"{w.id}: partitioned")
                if w.probe is not None:
                    status = w.probe(w)
                else:
                    status = _http_probe(w, self.probe_timeout_s)
            except Exception:  # noqa: BLE001 — any probe failure is a miss
                self._miss(w)
            else:
                # probe contract: a status string, or (status, nonce)
                # where nonce is the worker's incarnation witness
                nonce = None
                if isinstance(status, tuple):
                    status, nonce = status
                self._verdict(w, status, nonce)
            self._g_state.set(STATE_CODES[w.state], worker=w.id)

    def _miss(self, w: WorkerInfo) -> None:
        w.misses += 1
        self._c_misses.inc(1, worker=w.id)
        if w.misses >= self.death_misses:
            w.state = DOWN
        elif w.misses >= self.suspect_misses and w.state != DOWN:
            # partition ≠ crash: out of rotation, nothing torn down
            w.state = SUSPECT

    def _verdict(self, w: WorkerInfo, status: str,
                 nonce: Optional[str] = None) -> None:
        w.misses = 0
        w.last_seen = time.monotonic()
        fresh_incarnation = (nonce is not None
                             and w.incarnation is not None
                             and nonce != w.incarnation)
        if w.state == DOWN:
            # resurrection (restarted process / healed partition): fresh
            # breaker, no inherited failure streak
            w.reset_breaker()
            w.revivals += 1
        elif fresh_incarnation:
            # the process restarted without us ever declaring it DOWN
            # (fast respawn, or a supervisor rebind raced the probe):
            # same contract — the dead incarnation's breaker/suspect
            # state must not survive into the new one
            w.reset_breaker()
            w.draining = False
            w.revivals += 1
        if nonce is not None:
            w.incarnation = nonce
        if status.startswith("degraded"):
            w.state = DEGRADED
            w.degraded_reason = status.partition(":")[2]
        elif status.startswith("warming"):
            # compile-ahead still running: suspend NEW dispatch (pick()
            # only serves the UP/DEGRADED tiers) without calling the
            # worker unhealthy — it reports ready when warmup completes
            w.state = WARMING
            w.degraded_reason = status.partition(":")[2]
        elif status.startswith(DRAINING):
            # the worker announced its own graceful drain: out of NEW
            # selection (pick() only serves the UP/DEGRADED tiers) but
            # not unhealthy — its live sessions still flow, and the
            # stateful router migrates them off before the deadline
            w.state = DRAINING
        elif status in ("unhealthy", UNHEALTHY):
            w.state = UNHEALTHY
        else:
            w.state = UP
            w.degraded_reason = ""

    # -- selection -----------------------------------------------------------

    def pick(self, exclude=()) -> WorkerInfo:
        """Choose a worker for one dispatch (or one new session):
        round-robin over UP workers, falling back to DEGRADED ones only
        when no UP worker is eligible; WARMING / SUSPECT / UNHEALTHY /
        DOWN / draining workers and open per-worker breakers never
        receive new work.  Raises :class:`NoWorkerAvailable`."""
        with self._lock:
            members = list(self._workers.values())
            self._rr += 1
            offset = self._rr
        for tier in (UP, DEGRADED):
            n = len(members)
            for i in range(n):
                w = members[(offset + i) % n]
                if (w.state != tier or w.draining or w.id in exclude
                        or w.block_data):
                    continue
                try:
                    # breaker contract: every allow() is followed by
                    # exactly one report_success/report_failure from the
                    # router's forward attempt
                    w.breaker.allow()
                except BreakerOpenError:
                    self.quarantine_skips += 1
                    continue
                return w
        raise NoWorkerAvailable(
            "no eligible fleet worker "
            f"({len(members)} registered, {len(tuple(exclude))} excluded)")

    def report_success(self, w: WorkerInfo) -> None:
        w.routed += 1
        w.breaker.record_success()

    def report_failure(self, w: WorkerInfo) -> None:
        w.failures += 1
        w.breaker.record_failure()

    # -- rebalance -----------------------------------------------------------

    def drain(self, worker_id: str) -> WorkerInfo:
        """Planned removal, step 1: no new sessions or dispatches; live
        sessions keep flowing (the router waits them out)."""
        w = self.get(worker_id)
        w.draining = True
        return w

    def eject(self, worker_id: str) -> None:
        """Planned removal, step 2 (or confirmed death): out of the
        fleet.  The entry stays in the roster so a restarted worker on
        the same address revives via the probe path."""
        w = self.get(worker_id)
        w.state = DOWN
        self._g_state.set(STATE_CODES[DOWN], worker=w.id)

    def trace_sources(self) -> Dict[str, str]:
        """``{worker_id: "host:port"}`` of every member with a metrics
        endpoint — the roster the cluster trace collector
        (:meth:`nnstreamer_tpu_torch.obs.collector.TraceCollector.add_fleet`)
        federates ``/trace.json`` and ``/metrics`` from."""
        return {w.id: w.health_addr for w in self.workers()
                if w.health_addr}

    def stats(self) -> dict:
        return {
            "workers": {w.id: w.snapshot() for w in self.workers()},
            "sweeps": self.sweeps,
            "quarantine_skips": self.quarantine_skips,
            "heartbeat_s": self.heartbeat_s,
        }
