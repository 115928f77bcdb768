"""Supervised worker lifecycle for the elastic fleet.

The port of the JAX package's ``fleet/supervisor.py``.  A subprocess worker
runs on the card unless the factory asks for the CPU
(``SubprocWorkerFactory(device="cpu")`` passes ``--device cpu``), and a
worker that cannot load or launch its kernels fails its spawn.

The autoscaler (:mod:`.autoscaler`) decides *how many* workers should
exist; this module owns the *mechanics* of making that true and keeping
it true while workers crash:

- **spawn**: bring a new worker up — in-process (:class:`
  InProcWorkerFactory`, tests and the loadgen harness) or as a real
  subprocess (:class:`SubprocWorkerFactory`, ``python -m
  nnstreamer_tpu_torch.fleet worker`` with EVERY port requested ephemeral and
  the chosen ones read back off the JSON ports line, so a fresh worker
  never collides with a draining predecessor's still-releasing port).
  Joins are **warming-gated**: a spawned worker is ``joining`` until its
  probe reports routable (``ok``/``degraded``), so compile-ahead warmup
  finishes before membership hands it traffic, and **asynchronous**: a
  slow or wedged spawn never blocks the control loop — it times out
  (``[autoscale] spawn_timeout_s``), counts ``failed``, and the fleet
  keeps serving at its current size.
- **supervised respawn**: a managed worker that dies (kill -9, crash)
  is respawned with capped-exponential backoff (``[autoscale]
  respawn_backoff_ms`` → ``_cap_ms``, reset after a healthy join).  The
  respawned incarnation re-registers through
  :meth:`~.membership.Membership.rebind`, so nothing of the dead
  incarnation's breaker/suspect state survives — whatever address the
  new process came back on.
- **crash-loop quarantine**: ``[autoscale] crash_limit`` deaths inside
  ``crash_window_s`` hold the worker DOWN for ``quarantine_s`` with the
  WHY recorded in :meth:`Supervisor.stats` (mirroring the graph
  runtime's restart-storm semantics): a worker that cannot stay up must
  not burn the spawn budget or flap membership.  Release re-attempts the
  spawn once the hold expires.
- **drain**: scale-down removes the NEWEST worker first, migrate-first —
  every surface's router runs its ``drain_worker`` (live decode-session
  migration on stateful routers) before the handle gets its SIGTERM —
  and runs on a helper thread so a slow drain never wedges the loop.

Every spawn intent resolves exactly once in the ledger —
``spawns == joined + failed + quarantined + cancelled (+ pending)`` — the
exactness invariant the autoscale CI gate asserts.  Chaos: each spawn attempt
consults the ``autoscale`` fault point (:func:`nnstreamer_tpu_torch.faults.
maybe_spawn_fail`, site ``<name>:spawn:<worker>``) so a seeded
``spawn_fail`` schedule exercises the degrade path reproducibly.
"""

from __future__ import annotations

import collections
import json
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import faults as _faults
from ..obs import hooks as _hooks
from ..obs import spans as _spans
from .membership import Membership
from .worker import FleetWorker


class SpawnError(RuntimeError):
    """A worker spawn attempt failed (bad binary, port in use, ports
    line never arrived, injected ``spawn_fail``)."""


class ScaleEventLog:
    """Shared scale-event sink: the autoscaler and its supervisor both
    record here, so one timeline carries spawn/drain/quarantine/storm in
    order — exported in ``stats()["events"]``, counted in
    ``nnstpu_autoscale_events_total{action}``, emitted on the
    ``scale_event`` hook, and dropped as ``scale:<action>`` instants on
    the Perfetto timeline when span tracing is active."""

    MAX_EVENTS = 4096  # a week of churn, not an unbounded leak

    def __init__(self, name: str, registry=None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = str(name)
        self._clock = clock
        self._lock = threading.Lock()
        self.events: collections.deque = collections.deque(
            maxlen=self.MAX_EVENTS)
        if registry is None:
            from ..obs.metrics import REGISTRY

            registry = REGISTRY
        self._c_events = registry.counter(
            "nnstpu_autoscale_events_total",
            "fleet autoscaler actions (spawn / join / spawn_fail / "
            "drain / respawn / quarantine / release / flap_damped / "
            "storm)", labelnames=("action",))

    def emit(self, action: str, worker: str = "", detail: str = "",
             fleet: Optional[int] = None) -> dict:
        rec = {"t": self._clock(), "action": action, "worker": worker,
               "detail": detail}
        if fleet is not None:
            rec["fleet"] = fleet
        with self._lock:
            self.events.append(rec)
        self._c_events.inc(1, action=action)
        if _hooks.enabled:
            _hooks.emit("scale_event", self.name, action, worker, detail)
        if _spans.enabled:
            _spans.record_instant(
                f"scale:{action}", cat="autoscale", trace=(0, 0),
                args={"worker": worker, "detail": detail,
                      **({"fleet": fleet} if fleet is not None else {})})
        return rec

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self.events]

    def count(self, action: str) -> int:
        with self._lock:
            return sum(1 for e in self.events if e["action"] == action)


class Surface:
    """One traffic class the fleet serves: which membership roster the
    worker joins, which of its reported ports that roster routes to, and
    (optionally) the router whose ``drain_worker`` runs migrate-first
    drains for it."""

    def __init__(self, membership: Membership, router=None,
                 port_key: str = "port", name: str = "query"):
        self.membership = membership
        self.router = router
        self.port_key = port_key
        self.name = name


# -- worker handles ----------------------------------------------------------


class InProcWorkerHandle:
    """A :class:`~.worker.FleetWorker` living in this process."""

    def __init__(self, worker: FleetWorker):
        self.worker = worker
        self.pid = None

    @property
    def ports(self) -> dict:
        return {"port": self.worker.query_port,
                "decode_port": self.worker.decode_port,
                "health_addr": self.worker.trace_addr}

    @property
    def nonce(self) -> str:
        return self.worker.incarnation

    @property
    def probe(self):
        return self.worker.probe_inc

    def alive(self) -> bool:
        return not self.worker._killed

    def terminate(self, drain: bool = True,
                  timeout: Optional[float] = None) -> None:
        if drain:
            self.worker.drain(timeout)
            self.worker.stop()
        else:
            self.worker.stop()

    def kill(self) -> None:
        self.worker.kill()


class SubprocWorkerHandle:
    """A ``python -m nnstreamer_tpu_torch.fleet worker`` process."""

    def __init__(self, proc: subprocess.Popen, info: dict):
        self.proc = proc
        self.info = info
        self.pid = proc.pid

    @property
    def ports(self) -> dict:
        health = self.info.get("health_port")
        return {"port": self.info.get("port"),
                "decode_port": self.info.get("decode_port"),
                "health_addr": f"127.0.0.1:{health}" if health else None}

    @property
    def nonce(self) -> Optional[str]:
        return self.info.get("nonce")

    @property
    def probe(self):
        return None  # membership probes /healthz over HTTP

    def alive(self) -> bool:
        return self.proc.poll() is None

    def terminate(self, drain: bool = True,
                  timeout: Optional[float] = None) -> None:
        try:
            self.proc.send_signal(
                signal.SIGTERM if drain else signal.SIGINT)
        except OSError:
            return
        try:
            self.proc.wait(timeout=timeout if timeout else 10.0)
        except subprocess.TimeoutExpired:
            self.kill()

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass


# -- factories ---------------------------------------------------------------


class InProcWorkerFactory:
    """Build in-process :class:`FleetWorker`\\ s (tests, loadgen).
    ``worker_kwargs`` is the template; ports always default ephemeral."""

    def __init__(self, **worker_kwargs):
        self.worker_kwargs = dict(worker_kwargs)

    def spawn(self, wid: str) -> InProcWorkerHandle:
        kwargs = dict(self.worker_kwargs)
        engine = kwargs.pop("engine", None)
        w = FleetWorker(name=wid, port=0,
                        engine=dict(engine) if engine else None,
                        decode_port=0 if engine else None, **kwargs)
        return InProcWorkerHandle(w.start())


class SubprocWorkerFactory:
    """Spawn real worker processes and parse their JSON ports line.

    Every port is requested ephemeral (``--port 0 --health-port 0
    --decode-port 0``); the chosen NNSQ / decode / metrics ports come
    back on the ports line and are what membership consumes — a worker
    spawned while its predecessor's socket is still in TIME_WAIT can
    never collide with it.  A process that dies before printing the line
    (bad binary, unimportable flag, a kernel that does not load or
    launch) or never prints it within ``line_timeout_s`` is a
    :class:`SpawnError` — the degrade path, not a wedge.

    ``device`` is passed as ``--device``: the card by default, ``"cpu"``
    on request.  Workers are new interpreters (``subprocess``), never
    forks of a process whose CUDA context is up.  ``stderr`` is where
    the workers' standard error goes (``None`` inherits this process's,
    the default discards it)."""

    def __init__(self, worker_args: Optional[List[str]] = None,
                 env: Optional[dict] = None, device: Optional[str] = "cuda",
                 line_timeout_s: float = 60.0, python: Optional[str] = None,
                 stderr=subprocess.DEVNULL):
        self.worker_args = list(worker_args or [])
        self.env = env
        self.device = device
        self.line_timeout_s = float(line_timeout_s)
        self.python = python or sys.executable
        self.stderr = stderr

    def spawn(self, wid: str) -> SubprocWorkerHandle:
        argv = [self.python, "-m", "nnstreamer_tpu_torch.fleet", "worker",
                "--name", wid, "--port", "0", "--health-port", "0",
                "--decode-port", "0"] + self.worker_args
        if self.device:
            argv += ["--device", self.device]
        try:
            proc = subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=self.stderr,
                text=True, env=self.env)
        except OSError as exc:  # bad binary / exec failure
            raise SpawnError(f"{wid}: spawn failed: {exc}") from exc
        line: Dict[str, str] = {}

        def read_line():
            try:
                line["raw"] = proc.stdout.readline()
            except (OSError, ValueError):
                line["raw"] = ""

        t = threading.Thread(target=read_line, daemon=True,
                             name=f"spawn-ports:{wid}")
        t.start()
        t.join(timeout=self.line_timeout_s)
        raw = line.get("raw", "")
        if not raw:
            try:
                proc.kill()
            except OSError:
                pass
            raise SpawnError(
                f"{wid}: no ports line within {self.line_timeout_s}s "
                f"(rc={proc.poll()})")
        try:
            info = json.loads(raw)
        except ValueError as exc:
            try:
                proc.kill()
            except OSError:
                pass
            raise SpawnError(
                f"{wid}: unparseable ports line {raw!r}") from exc

        def drain_stdout():
            # anything the worker prints after its ports line is read and
            # dropped, so a full pipe never blocks it
            try:
                for _ in proc.stdout:
                    pass
            except (OSError, ValueError):
                pass

        threading.Thread(target=drain_stdout, daemon=True,
                         name=f"spawn-stdout:{wid}").start()
        return SubprocWorkerHandle(proc, info)


# -- the supervisor ----------------------------------------------------------

# managed-worker states
SPAWNING = "joining"      # spawned, waiting for a routable probe verdict
READY = "up"              # joined the fleet
DRAINING_STATE = "draining"
DEAD = "dead"               # died; respawn pending (backoff)
QUARANTINED = "quarantined"
REMOVED = "removed"


class ManagedWorker:
    """Supervisor-side record of one worker across incarnations."""

    def __init__(self, wid: str, clock):
        self.wid = wid
        self.handle = None
        self.state = SPAWNING
        self.deaths: collections.deque = collections.deque()
        self.backoff_ms = 0.0
        self.respawn_at = 0.0        # next respawn attempt (clock time)
        self.join_deadline = 0.0
        self.quarantined_until = 0.0
        self.quarantine_reason = ""
        self.spawn_seq = 0           # LIFO victim selection on scale-down
        self.restarts = 0
        self._clock = clock

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "restarts": self.restarts,
            "deaths": len(self.deaths),
            "backoff_ms": self.backoff_ms,
            "quarantine_reason": self.quarantine_reason,
            "quarantined_for_s": max(
                0.0, self.quarantined_until - self._clock())
            if self.state == QUARANTINED else 0.0,
            "pid": getattr(self.handle, "pid", None),
        }


class Supervisor:
    """Spawn/respawn/quarantine/drain mechanics over a worker factory.

    Drive :meth:`tick` from the autoscaler's control loop (or directly
    in tests); every action lands in the shared :class:`ScaleEventLog`
    and the spawn ledger stays exact."""

    def __init__(self, factory, surfaces: List[Surface],
                 name: str = "fleet", events: Optional[ScaleEventLog] = None,
                 clock: Callable[[], float] = time.monotonic,
                 crash_limit: Optional[int] = None,
                 crash_window_s: Optional[float] = None,
                 quarantine_s: Optional[float] = None,
                 respawn_backoff_ms: Optional[float] = None,
                 respawn_backoff_cap_ms: Optional[float] = None,
                 spawn_timeout_s: Optional[float] = None,
                 drain_deadline_s: Optional[float] = None):
        from ..conf import conf

        def _f(key, arg, default):
            return float(arg) if arg is not None else \
                conf.get_float("autoscale", key, default)

        self.factory = factory
        self.surfaces = list(surfaces)
        self.name = str(name)
        self.events = events if events is not None else ScaleEventLog(name)
        self._clock = clock
        self.crash_limit = (int(crash_limit) if crash_limit is not None
                            else conf.get_int("autoscale", "crash_limit", 3))
        self.crash_window_s = _f("crash_window_s", crash_window_s, 30.0)
        self.quarantine_s = _f("quarantine_s", quarantine_s, 30.0)
        self.respawn_backoff_ms = _f(
            "respawn_backoff_ms", respawn_backoff_ms, 200.0)
        self.respawn_backoff_cap_ms = _f(
            "respawn_backoff_cap_ms", respawn_backoff_cap_ms, 5000.0)
        self.spawn_timeout_s = _f("spawn_timeout_s", spawn_timeout_s, 30.0)
        self.drain_deadline_s = _f(
            "drain_deadline_s", drain_deadline_s,
            conf.get_float("fleet", "drain_deadline_s", 10.0))
        self._lock = threading.Lock()
        self._managed: Dict[str, ManagedWorker] = {}
        self._seq = 0
        # the spawn ledger: every intent resolves exactly once —
        # spawns == joined + failed + quarantined + cancelled
        # + pending(joining)
        self.spawns = 0
        self.joined = 0
        self.spawn_failed = 0
        self.quarantined_total = 0
        self.cancelled = 0  # spawns drained by a scale-down before they joined
        self._drain_threads: List[threading.Thread] = []

    # -- roster ---------------------------------------------------------------

    def managed(self) -> List[ManagedWorker]:
        with self._lock:
            return list(self._managed.values())

    def get(self, wid: str) -> ManagedWorker:
        with self._lock:
            return self._managed[wid]

    def worker_count(self, include_joining: bool = True) -> int:
        """Workers the fleet can count on: READY plus (by default) ones
        still warming toward their join AND dead ones whose respawn
        backoff is pending — the autoscaler compares its desired count
        against THIS, so neither a slow warmup nor a respawn-in-backoff
        triggers a duplicate provisioning spawn.  Quarantined workers do
        NOT count: they are held down indefinitely and the controller
        may legitimately replace their capacity."""
        with self._lock:
            return sum(1 for m in self._managed.values()
                       if m.state == READY
                       or (include_joining
                           and m.state in (SPAWNING, DEAD)))

    def ready_count(self) -> int:
        return self.worker_count(include_joining=False)

    def quarantined_count(self) -> int:
        with self._lock:
            return sum(1 for m in self._managed.values()
                       if m.state == QUARANTINED)

    def draining_count(self) -> int:
        """Drains still in flight — the autoscaler serializes on this
        (one drain at a time), so a down-slope is a ROLLING drain: a
        migrating session can never be handed to a worker that is about
        to drain out from under it in the same transition."""
        with self._lock:
            return sum(1 for m in self._managed.values()
                       if m.state == DRAINING_STATE)

    def adopt(self, wid: str, handle) -> ManagedWorker:
        """Take over an already-running worker (the fleet's initial
        floor): counted as one resolved spawn so the ledger covers the
        whole roster."""
        with self._lock:
            self._seq += 1
            m = ManagedWorker(wid, self._clock)
            m.handle = handle
            m.state = READY
            m.spawn_seq = self._seq
            self._managed[wid] = m
            self.spawns += 1
            self.joined += 1
        self._register(wid, handle, fresh=True, adopted=True)
        return m

    # -- spawn / join ---------------------------------------------------------

    def next_wid(self) -> str:
        with self._lock:
            self._seq += 1
            return f"{self.name}-w{self._seq}"

    def spawn_worker(self, wid: Optional[str] = None,
                     detail: str = "") -> Optional[str]:
        """One spawn intent: consult the chaos point, run the factory,
        register every surface, and leave the worker ``joining`` until
        its probe proves routable (:meth:`tick` resolves it).  Any
        failure resolves the intent as ``failed`` and returns None — the
        control loop stays un-wedged and the current fleet keeps
        serving."""
        fresh = wid is None
        if wid is None:
            wid = self.next_wid()
        with self._lock:
            m = self._managed.get(wid)
            if m is None:
                m = ManagedWorker(wid, self._clock)
                m.spawn_seq = self._seq
                self._managed[wid] = m
            self.spawns += 1
        try:
            if _faults.enabled:
                _faults.maybe_spawn_fail(f"{self.name}:spawn:{wid}")
            handle = self.factory.spawn(wid)
        except Exception as exc:  # noqa: BLE001 — degrade, never wedge
            with self._lock:
                self.spawn_failed += 1
                m.state = REMOVED if fresh else m.state
            self.events.emit("spawn_fail", wid, repr(exc),
                             fleet=self.worker_count())
            return None
        with self._lock:
            m.handle = handle
            m.state = SPAWNING
            m.join_deadline = self._clock() + self.spawn_timeout_s
        self._register(wid, handle, fresh=fresh)
        self.events.emit("spawn", wid, detail, fleet=self.worker_count())
        return wid

    def _register(self, wid: str, handle, fresh: bool,
                  adopted: bool = False) -> None:
        """Register (or rebind) the worker's reported addresses with
        every surface's membership — the supervisor consumes the ports
        the spawn reported, never the ports it wished for."""
        ports = handle.ports
        for s in self.surfaces:
            port = ports.get(s.port_key)
            if not port:
                continue
            if fresh:
                # adopted workers already serve; a spawn is unprobed until
                # its first probe answers (it may still be capturing)
                s.membership.add("127.0.0.1", port, worker_id=wid,
                                 health_addr=ports.get("health_addr"),
                                 probe=handle.probe, assume_up=adopted)
            else:
                s.membership.rebind(wid, "127.0.0.1", port,
                                    health_addr=ports.get("health_addr"),
                                    probe=handle.probe)

    def _probe_ready(self, m: ManagedWorker) -> bool:
        """Routable = every surface's verdict is UP or DEGRADED (unprobed
        / warming / draining / suspect are not): a spawn's entry reads
        unprobed until a probe of its incarnation answers, so no pass
        joins a worker that no probe has seen."""
        from .membership import DEGRADED, UP

        for s in self.surfaces:
            try:
                info = s.membership.get(m.wid)
            except KeyError:
                continue
            if info.state not in (UP, DEGRADED):
                return False
        return True

    # -- drain (scale-down) ---------------------------------------------------

    def pick_victim(self) -> Optional[str]:
        """Scale-down victim.  A worker still joining goes first (the
        newest): it holds no traffic and no session, and the controller
        counted it.  Else the NEWEST ready worker (LIFO) — the
        longest-lived workers hold the warmest caches and the most
        sessions; the marginal capacity leaves first — but never the last
        ready one while another worker still counts toward the fleet (a
        spawn in flight, a respawn pending): that drain would leave nothing
        routable.  The JAX package drains the newest ready worker even when
        the only other one is still joining (ROADMAP C21)."""
        with self._lock:
            joining = [m for m in self._managed.values()
                       if m.state == SPAWNING and m.handle is not None]
            if joining:
                return max(joining, key=lambda m: m.spawn_seq).wid
            ready = [m for m in self._managed.values() if m.state == READY]
            counted = sum(1 for m in self._managed.values()
                          if m.state in (READY, SPAWNING, DEAD))
            if not ready or (len(ready) == 1 and counted > 1):
                return None
            return max(ready, key=lambda m: m.spawn_seq).wid

    def drain_worker(self, wid: str, detail: str = "",
                     blocking: bool = False) -> bool:
        """Planned removal, migrate-first: every surface router runs its
        ``drain_worker`` (live decode-session migration on stateful
        routers) before the handle's SIGTERM.  Runs on a helper thread
        unless ``blocking`` — a slow drain must not stall the control
        loop."""
        with self._lock:
            m = self._managed.get(wid)
            if m is None or m.state not in (READY, SPAWNING):
                return False
            if m.state == SPAWNING:
                # the spawn intent resolves here: it never joins
                self.cancelled += 1
                detail = f"{detail}; cancelled while joining" if detail \
                    else "cancelled while joining"
            m.state = DRAINING_STATE
        self.events.emit("drain", wid, detail, fleet=self.worker_count())

        def run():
            for s in self.surfaces:
                try:
                    if s.router is not None:
                        s.router.drain_worker(
                            wid, deadline_s=self.drain_deadline_s)
                    else:
                        s.membership.drain(wid)
                        s.membership.eject(wid)
                except Exception:  # noqa: BLE001 — keep tearing down
                    import logging

                    logging.getLogger("nnstreamer_tpu_torch.fleet").exception(
                        "%s: drain of %s on surface %s failed",
                        self.name, wid, s.name)
            handle = m.handle
            if handle is not None:
                try:
                    handle.terminate(drain=True,
                                     timeout=self.drain_deadline_s)
                except Exception:  # noqa: BLE001
                    pass
            with self._lock:
                m.state = REMOVED

        if blocking:
            run()
        else:
            t = threading.Thread(target=run, daemon=True,
                                 name=f"drain:{wid}")
            t.start()
            self._drain_threads.append(t)
        return True

    def join_drains(self, timeout: float = 30.0) -> None:
        """Wait out in-flight drain threads (tests / shutdown)."""
        threads, self._drain_threads = self._drain_threads, []
        for t in threads:
            t.join(timeout=timeout)

    # -- the supervision pass -------------------------------------------------

    def tick(self) -> None:
        """One supervision pass: resolve joins, detect deaths, respawn
        with backoff, trip and release crash-loop quarantines."""
        now = self._clock()
        for m in self.managed():
            if m.state == SPAWNING:
                if m.handle is None:
                    # its spawn is still running on another thread: nothing
                    # is registered yet, so no probe can call it ready
                    continue
                self._tick_joining(m, now)
            elif m.state == READY:
                if m.handle is not None and not m.handle.alive():
                    self._on_death(m, now)
            elif m.state == DEAD:
                self._maybe_respawn(m, now)
            elif m.state == QUARANTINED:
                if now >= m.quarantined_until:
                    self._release(m)

    def _tick_joining(self, m: ManagedWorker, now: float) -> None:
        if m.handle is not None and not m.handle.alive():
            # died before it ever joined: a failed spawn, and a death
            # toward the crash-loop window
            with self._lock:
                self.spawn_failed += 1
            self.events.emit("spawn_fail", m.wid,
                             "died before joining",
                             fleet=self.worker_count())
            self._on_death(m, now, count_attempt=False)
            return
        if self._probe_ready(m):
            with self._lock:
                m.state = READY
                m.backoff_ms = 0.0  # healthy join resets the backoff
                self.joined += 1
            self.events.emit("join", m.wid, fleet=self.worker_count())
        elif now >= m.join_deadline:
            # warmup/probe never converged: resolve failed, tear down
            with self._lock:
                self.spawn_failed += 1
                m.state = REMOVED
            self.events.emit("spawn_fail", m.wid,
                             f"join timeout after {self.spawn_timeout_s}s",
                             fleet=self.worker_count())
            if m.handle is not None:
                try:
                    m.handle.kill()
                except Exception:  # noqa: BLE001
                    pass
            self._eject_everywhere(m.wid)

    def _on_death(self, m: ManagedWorker, now: float,
                  count_attempt: bool = True) -> None:
        del count_attempt
        m.deaths.append(now)
        while m.deaths and m.deaths[0] < now - self.crash_window_s:
            m.deaths.popleft()
        self._eject_everywhere(m.wid)
        if len(m.deaths) >= self.crash_limit:
            # crash loop: hold the worker down with the WHY visible —
            # counted as one resolved spawn intent so the ledger stays
            # exact (the respawn this death earned was absorbed here)
            with self._lock:
                m.state = QUARANTINED
                m.quarantined_until = now + self.quarantine_s
                m.quarantine_reason = (
                    f"crash loop: {len(m.deaths)} deaths in "
                    f"{self.crash_window_s:g}s window; held down "
                    f"{self.quarantine_s:g}s")
                self.spawns += 1
                self.quarantined_total += 1
            self.events.emit("quarantine", m.wid, m.quarantine_reason,
                             fleet=self.worker_count())
            return
        # capped-exponential respawn backoff
        m.backoff_ms = min(
            self.respawn_backoff_cap_ms,
            m.backoff_ms * 2 if m.backoff_ms else self.respawn_backoff_ms)
        m.respawn_at = now + m.backoff_ms / 1e3
        with self._lock:
            m.state = DEAD
        # the respawn happens when the backoff expires (checked below on
        # this same tick so a zero backoff respawns immediately)
        self._maybe_respawn(m, now)

    def _maybe_respawn(self, m: ManagedWorker, now: float) -> None:
        if m.state != DEAD or now < m.respawn_at:
            return
        m.restarts += 1
        self.events.emit("respawn", m.wid,
                         f"death #{len(m.deaths)}, backoff "
                         f"{m.backoff_ms:g}ms",
                         fleet=self.worker_count())
        self.spawn_worker(m.wid)

    def _release(self, m: ManagedWorker) -> None:
        with self._lock:
            m.state = DEAD
            m.deaths.clear()
            m.backoff_ms = 0.0
            m.respawn_at = 0.0
            reason, m.quarantine_reason = m.quarantine_reason, ""
        self.events.emit("release", m.wid,
                         f"quarantine expired ({reason})",
                         fleet=self.worker_count())
        self._maybe_respawn(m, self._clock())

    def poll_respawns(self) -> None:
        """Give backed-off respawns their chance (part of tick for
        callers driving the loop manually)."""
        now = self._clock()
        for m in self.managed():
            self._maybe_respawn(m, now)

    def _eject_everywhere(self, wid: str) -> None:
        for s in self.surfaces:
            try:
                s.membership.eject(wid)
            except KeyError:
                pass

    # -- teardown / stats -----------------------------------------------------

    def stop(self, drain: bool = False) -> None:
        """Tear down every managed worker (tests / process exit)."""
        for m in self.managed():
            if m.handle is None:
                continue
            try:
                m.handle.terminate(drain=drain, timeout=2.0)
            except Exception:  # noqa: BLE001
                pass
            with self._lock:
                m.state = REMOVED
        self.join_drains()

    def stats(self) -> dict:
        with self._lock:
            workers = {wid: m.snapshot()
                       for wid, m in self._managed.items()}
            pending = sum(1 for m in self._managed.values()
                          if m.state == SPAWNING)
            out = {
                "name": self.name,
                "spawns": self.spawns,
                "joined": self.joined,
                "failed": self.spawn_failed,
                "quarantined": self.quarantined_total,
                "cancelled": self.cancelled,
                "pending": pending,
                "workers": workers,
            }
        # the exactness invariant the CI gate asserts: every spawn
        # intent resolved (or still visibly pending) — nothing leaked
        out["ledger_exact"] = (
            out["spawns"] == out["joined"] + out["failed"]
            + out["quarantined"] + out["cancelled"] + out["pending"])
        return out


def worker_pids(sup: Supervisor) -> Dict[str, Optional[int]]:
    """{wid: pid} for subprocess fleets (the CI smoke's kill -9 needs
    real pids); in-process handles report None."""
    return {m.wid: getattr(m.handle, "pid", None) for m in sup.managed()}


__all__ = [
    "InProcWorkerFactory", "InProcWorkerHandle", "ManagedWorker",
    "ScaleEventLog", "SpawnError", "SubprocWorkerFactory",
    "SubprocWorkerHandle", "Supervisor", "Surface", "worker_pids",
]
