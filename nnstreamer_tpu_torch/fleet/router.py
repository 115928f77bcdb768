"""The NNSQ fleet router: one front door, N worker processes.

The port of the JAX package's ``fleet/router.py``.  The router moves wire
frames and never touches a tensor's device: its replies, its ledger and its
re-route decisions are the JAX package's on the same traffic, and a stock
client of either package talks to it unchanged.

Clients speak the stock ``NNSQ`` wire protocol
(:mod:`nnstreamer_tpu_torch.elements.query`) to the router exactly as they
would to a single ``QueryServer``/``DecodeServer`` — the fleet is
invisible until something fails:

- **stateless** traffic (``stateful=False``, the QueryServer surface)
  is load-balanced per request across the membership's eligible
  workers.  A forward that hits a dead, killed, or partitioned worker
  is transparently re-routed and retried (bounded attempts, capped
  exponential backoff) — the client sees its reply, never the failure.
  Typed worker rejections are fleet-aware: ``[OVERLOAD]`` /
  ``[UNAVAILABLE]`` from one worker (it is shedding or draining) send
  the request to the next worker, and only when the whole fleet refuses
  does the typed error surface; ``[EXPIRED]`` surfaces immediately (the
  deadline already passed — a second worker cannot un-expire it).
- **stateful** decode sessions (``stateful=True``, the DecodeServer
  surface) are pinned sticky: the first real frame on a client
  connection picks a worker and every subsequent frame rides the same
  dedicated backend connection — the session id IS the connection, the
  same contract the DecodeServer applies.  A mid-session worker failure
  is NEVER replayed: the client gets the typed ``[SESSION]`` wire code
  (:class:`~nnstreamer_tpu_torch.elements.query.QuerySessionBrokenError`)
  immediately and rebuilds by reconnecting (re-prefill), because the
  dead worker's per-slot state is unrecoverable by definition.
  Negotiation probes (``PROBE_PTS``) never pin — they are stateless by
  contract and ride the re-routing path.

**Cluster-wide admission**: pass (or conf-activate, ``NNSTPU_SCHED_*``)
a :class:`nnstreamer_tpu_torch.sched.Scheduler` and its per-tenant token
buckets / bounded queues meter the WHOLE fleet's intake at the front
door — the ``sched/`` tenancy model extended across workers, where it
actually bounds aggregate load instead of per-process slices.

**Rebalance** (:meth:`Router.drain_worker`): stop new work via
membership draining, then **live-migrate** every pinned decode session
to another worker (quiesce at a tick boundary → snapshot the engine
slot through the ``[fleet] repo_addr`` TensorRepo → restore on the
target → re-pin the client's sticky backend socket; the client keeps
streaming, token-identical).  Only what cannot migrate (old workers on
the version-gated wire path, no repo, no spare capacity, an injected
``migrate_abort``) degrades to the legacy path: wait to the deadline,
force-break with ``[SESSION]``, eject.  A migration monitor applies the
same handoff to workers that announce their OWN drain (SIGTERM →
``draining`` probe verdict) — true rolling restarts.

With span tracing active the router records an ``nnsq_route`` span on
the client's wire trace and forwards its span id as the worker-side
parent, so one request renders as the full hop — client ``nnsq_rtt`` →
router ``nnsq_route`` → worker ``nnsq_serve`` → ``device_invoke`` — in
the Perfetto export.
"""

from __future__ import annotations

import random
import socket
import threading
import time
import zlib
from typing import Dict, List, Optional, Set, Tuple

from .. import faults as _faults
from ..elements.query import (
    MIGRATE_PTS,
    PROBE_PTS,
    RESUME_PTS,
    QueryError,
    QueryExpiredError,
    QueryMigratingError,
    QueryOverloadError,
    QueryTimeoutError,
    QueryUnavailableError,
    pack_session_control,
    recv_tensors_ex,
    send_error,
    send_tensors,
)
from ..obs import spans as _spans
from .membership import DRAINING, Membership, NoWorkerAvailable, WorkerInfo


class _WorkerLink:
    """Pooled connections from the router to ONE worker.  A socket is
    checked out per forward and returned only after a clean round trip —
    any transport error drops it (the stream position is unknowable)."""

    MAX_IDLE = 4

    def __init__(self, worker: WorkerInfo, connect_timeout: float,
                 request_timeout: float):
        self.worker = worker
        self.generation = getattr(worker, "generation", 0)
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self._idle: List[socket.socket] = []
        self._lock = threading.Lock()

    def get(self) -> socket.socket:
        if self.worker.block_data:
            # chaos partition: the dial would never complete — surface
            # the same ConnectionError a refused connect would
            raise ConnectionError(f"{self.worker.id}: partitioned")
        with self._lock:
            if self._idle:
                return self._idle.pop()
        sock = socket.create_connection(
            self.worker.addr, timeout=self.connect_timeout)
        sock.settimeout(self.request_timeout)
        return sock

    def put(self, sock: socket.socket) -> None:
        with self._lock:
            if len(self._idle) < self.MAX_IDLE:
                self._idle.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def drop(self, sock: socket.socket) -> None:
        try:
            sock.close()
        except OSError:
            pass

    def close_all(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for sock in idle:
            try:
                sock.close()
            except OSError:
                pass


class _Session:
    """One pinned stateful session: client conn + dedicated worker sock."""

    __slots__ = ("worker", "sock", "client", "lock", "broken", "steps",
                 "mig_lock", "migrating")

    def __init__(self, worker: WorkerInfo, sock: socket.socket, client):
        self.worker = worker
        self.sock = sock
        self.client = client
        self.lock = threading.Lock()
        self.broken = False
        self.steps = 0
        # handoff gate: a forward holds it for the whole backend round
        # trip, a live migration holds it for the whole handoff — so a
        # client frame arriving mid-handoff simply waits, then rides the
        # NEW pinned socket (zero downtime, never a lost or torn step)
        self.mig_lock = threading.Lock()
        self.migrating = False


class Router:
    """NNSQ front door over a :class:`~.membership.Membership` roster."""

    def __init__(self, membership: Membership, host: str = "127.0.0.1",
                 port: int = 0, stateful: bool = False, scheduler=None,
                 route_retries: Optional[int] = None,
                 retry_backoff_ms: Optional[float] = None,
                 retry_backoff_cap_ms: Optional[float] = None,
                 connect_timeout: Optional[float] = None,
                 request_timeout: Optional[float] = None,
                 drain_deadline_s: Optional[float] = None,
                 name: str = "router",
                 repo_addr: Optional[str] = None,
                 migrate: Optional[bool] = None,
                 migrate_timeout_s: Optional[float] = None,
                 migrate_check_s: Optional[float] = None):
        """``repo_addr`` (``host:port`` of a
        :class:`~nnstreamer_tpu_torch.fleet.repo.TensorRepoServer`, default
        ``[fleet] repo_addr``) enables **live session migration** on a
        stateful router: a planned drain quiesces each pinned session,
        snapshots its engine state through the repo, restores it on
        another worker, and re-pins the client's backend socket — the
        client keeps streaming, token-identical.  ``migrate=False``
        (``[fleet] migrate``) keeps the legacy force-break drain."""
        from ..conf import conf

        def _f(key, arg, default):
            return float(arg) if arg is not None else \
                conf.get_float("fleet", key, default)

        self.membership = membership
        self.host, self.port = host, int(port)
        self.stateful = bool(stateful)
        self.name = str(name)
        self.route_retries = (int(route_retries) if route_retries is not None
                              else conf.get_int("fleet", "route_retries", 3))
        self.retry_backoff_ms = _f("retry_backoff_ms", retry_backoff_ms, 20.0)
        self.retry_backoff_cap_ms = _f(
            "retry_backoff_cap_ms", retry_backoff_cap_ms, 500.0)
        self.connect_timeout = _f("connect_timeout_s", connect_timeout, 5.0)
        self.request_timeout = _f("request_timeout_s", request_timeout, 30.0)
        self.drain_deadline_s = _f("drain_deadline_s", drain_deadline_s, 10.0)
        self._own_sched = False
        if scheduler is None:
            from ..sched import configured_scheduler

            scheduler = configured_scheduler(self.name)
            self._own_sched = scheduler is not None
        self.scheduler = scheduler
        self._srv: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._running = False
        self._links: Dict[str, _WorkerLink] = {}
        self._links_lock = threading.Lock()
        self._sessions: Dict[str, Set[_Session]] = {}
        self._sessions_lock = threading.Lock()
        # deterministic jitter stream (chaos replays want stable backoff)
        self._rng = random.Random(zlib.crc32(self.name.encode()))
        # the recovery ledger: offered == delivered + sum(shed.values()),
        # with a per-tenant split so SLO reports (tools/loadgen.py) can
        # check goodput-under-overload tenant by tenant without scraping
        self._ledger_lock = threading.Lock()
        self.offered = 0
        self.delivered = 0
        self.shed: Dict[str, int] = {}
        self.tenants: Dict[str, Dict[str, int]] = {}
        self.rerouted = 0          # transport-failure re-dispatches
        self.sessions_opened = 0
        self.sessions_broken = 0
        self.sessions_closed = 0   # every session ends here exactly once
        self.sessions_migrated = 0
        self.migration_aborts: Dict[str, int] = {}  # phase -> count
        self._stats_key: Optional[str] = None
        # -- live migration (stateful routers) --------------------------------
        self.repo_addr = (str(repo_addr) if repo_addr is not None
                          else conf.get("fleet", "repo_addr", "") or "")
        self.migrate_enabled = (bool(migrate) if migrate is not None
                                else conf.get_bool("fleet", "migrate", True))
        self.migrate_timeout_s = _f("migrate_timeout_s", migrate_timeout_s,
                                    10.0)
        self.migrate_check_s = _f("migrate_check_s", migrate_check_s, 0.25)
        self._mig_seq = 0  # repo-slot key sequence (per-router namespace)
        self._mig_thread: Optional[threading.Thread] = None
        self._mig_stop = threading.Event()
        from ..obs.metrics import REGISTRY

        self._c_migrations = REGISTRY.counter(
            "nnstpu_session_migrations_total",
            "live decode-session migrations by result "
            "(ok / abort / fallback)", labelnames=("result",))
        self._h_migration = REGISTRY.histogram(
            "nnstpu_session_migration_seconds",
            "handoff duration of one live session migration "
            "(quiesce + snapshot + restore + re-pin)")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Router":
        _faults.ensure_configured()  # chaos runs cover the front door too
        self._srv = socket.create_server((self.host, self.port))
        self.port = self._srv.getsockname()[1]
        self._running = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"fleet-router:{self.name}")
        self._accept_thread.start()
        if self.stateful and self.migrate_enabled and self.repo_addr:
            # migration monitor: a worker that announces its OWN drain
            # (SIGTERM → probe verdict DRAINING) gets its live sessions
            # moved off before the worker-side deadline breaks them —
            # router-initiated drains (drain_worker) migrate inline
            self._mig_stop.clear()
            self._mig_thread = threading.Thread(
                target=self._migrate_monitor, daemon=True,
                name=f"fleet-migrate:{self.name}")
            self._mig_thread.start()
        from ..obs.export import register_stats

        self._stats_key = f"fleet:{self.name}"
        register_stats(self._stats_key, self.stats)
        return self

    def stop(self) -> None:
        self._running = False
        self._mig_stop.set()
        if self._mig_thread is not None:
            self._mig_thread.join(timeout=5)
            self._mig_thread = None
        if self._srv is not None:
            self._srv.close()
        with self._links_lock:
            links = list(self._links.values())
        for link in links:
            link.close_all()
        with self._sessions_lock:
            sessions = [s for group in self._sessions.values()
                        for s in group]
        for sess in sessions:
            for sock in (sess.sock, sess.client):
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        if self._stats_key is not None:
            from ..obs.export import unregister_stats

            unregister_stats(self._stats_key, self.stats)
            self._stats_key = None
        if self._own_sched and self.scheduler is not None:
            self.scheduler.close()

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- accept / serve ------------------------------------------------------

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True,
                name=f"fleet-router-conn:{self.name}").start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            peer = conn.getpeername()
            client, tenant = f"{peer[0]}:{peer[1]}", str(peer[0])
        except (OSError, IndexError):
            client = tenant = "unknown"
        with conn:
            if self.stateful:
                self._serve_stateful(conn, client)
            else:
                self._serve_stateless(conn, client, tenant)

    def _count_shed(self, reason: str, tenant: str = "") -> None:
        with self._ledger_lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1
            if tenant:
                self._tenant_entry(tenant)["shed"] += 1

    def _tenant_entry(self, tenant: str) -> Dict[str, int]:
        """Caller holds the ledger lock."""
        entry = self.tenants.get(tenant)
        if entry is None:
            entry = self.tenants[tenant] = {
                "offered": 0, "delivered": 0, "shed": 0}
        return entry

    def _serve_stateless(self, conn, client: str, peer_tenant: str) -> None:
        from ..sched import BreakerOpenError, OverloadError

        import numpy as np

        while self._running:
            try:
                tensors, pts, wtrace, wtenant = recv_tensors_ex(conn)
            except (ConnectionError, OSError):
                return
            # declared wire tenant wins over the peer IP: N tenants
            # behind one loadgen host (or one NAT) meter independently
            tenant = wtenant or peer_tenant
            with self._ledger_lock:
                self.offered += 1
                self._tenant_entry(tenant)["offered"] += 1
            # route span: child of the client's rtt span when the wire
            # carried a trace; otherwise a fresh trace (the hop is still
            # recorded).  The reply echoes the flag ONLY when the
            # request carried it — plain-v1 clients never see the bit.
            tok = None
            if _spans.enabled:
                tok = (_spans.span_begin(wtrace[0], wtrace[1])
                       if wtrace is not None
                       else _spans.span_begin(_spans.new_trace_id(), 0))
            # token layout: (span_id, t0, trace_id, parent, prev)
            fwd_trace = (tok[2], tok[0]) if tok is not None else None
            item = None
            worker_id = ""
            try:
                try:
                    if self.scheduler is not None:
                        t0 = tensors[0] if tensors else None
                        cost = (int(np.asarray(t0).shape[0])
                                if t0 is not None
                                and np.asarray(t0).ndim >= 1 else 1)
                        # cluster-wide admission: the whole fleet's
                        # intake is metered here, per tenant
                        item = self.scheduler.admit(
                            client, tenant=tenant, cost=max(1, cost))
                    outs, opts, w = self._forward(tensors, pts, fwd_trace,
                                                  tenant=wtenant)
                    worker_id = w.id
                    reply_trace = ((wtrace[0], tok[0])
                                   if tok is not None and wtrace is not None
                                   else None)
                    if tok is not None:
                        # record the route span BEFORE the reply bytes go
                        # out (same root-cause fix as the worker's
                        # nnsq_serve): a collector snapshotting on reply
                        # arrival must already see the whole chain
                        _spans.span_end(
                            tok, "nnsq_route", "fleet",
                            args={"client": client, "worker": worker_id})
                        tok = None
                    send_tensors(conn, outs, opts, trace=reply_trace,
                                 fault_key="nnsq.router")
                    with self._ledger_lock:
                        self.delivered += 1
                        self._tenant_entry(tenant)["delivered"] += 1
                finally:
                    if item is not None:
                        self.scheduler.release(item)
                    if tok is not None:  # error path: close the span typed
                        _spans.span_end(
                            tok, "nnsq_route", "fleet",
                            args={"client": client, "worker": worker_id})
            except (OverloadError, BreakerOpenError) as exc:
                self._count_shed(getattr(exc, "reason", "admission"), tenant)
                try:
                    send_error(conn, str(exc), code=exc.code)
                except OSError:
                    return
            except QueryError as exc:
                # typed fleet verdict (worker rejection after exhausting
                # alternatives, or no worker at all)
                self._count_shed(exc.code.lower() or "error", tenant)
                try:
                    send_error(conn, str(exc), code=exc.code)
                except OSError:
                    return
            except Exception as exc:  # noqa: BLE001 — report, keep serving
                self._count_shed("error", tenant)
                try:
                    send_error(conn, repr(exc))
                except OSError:
                    return

    # -- stateless forwarding ------------------------------------------------

    def _link(self, w: WorkerInfo) -> _WorkerLink:
        with self._links_lock:
            link = self._links.get(w.id)
            if link is None or link.worker is not w or \
                    link.generation != getattr(w, "generation", 0):
                # new, revived, or REBOUND worker (a supervisor
                # respawned it, possibly on different ports): fresh pool
                # — pooled sockets to the dead incarnation are garbage
                if link is not None:
                    link.close_all()
                link = _WorkerLink(w, self.connect_timeout,
                                   self.request_timeout)
                self._links[w.id] = link
            return link

    def _forward(self, tensors, pts,
                 trace: Optional[Tuple[int, int]],
                 tenant: Optional[str] = None
                 ) -> Tuple[tuple, int, WorkerInfo]:
        """One stateless request against the fleet: pick, forward, and on
        transport failure re-route to the next eligible worker (bounded,
        with capped backoff).  Typed worker rejections try the next
        worker too (the fleet absorbs one worker's shedding) and only
        surface when every candidate refused; ``[EXPIRED]`` surfaces
        immediately.  ``tenant`` (the client's declared wire identity)
        is forwarded so worker-side schedulers label the same tenant the
        front door admitted.  Returns ``(outs, pts, worker)``."""
        tried: Set[str] = set()
        last_typed: Optional[QueryError] = None
        delay_s = self.retry_backoff_ms / 1e3
        attempts = 1 + max(0, self.route_retries)
        for attempt in range(attempts):
            try:
                w = self.membership.pick(exclude=tried)
            except NoWorkerAvailable as exc:
                if last_typed is not None:
                    raise last_typed
                raise QueryUnavailableError(
                    f"{self.name}: {exc} (attempt {attempt + 1})") from exc
            link = self._link(w)
            try:
                sock = link.get()
            except (ConnectionError, OSError):
                self.membership.report_failure(w)
                tried.add(w.id)
                with self._ledger_lock:
                    self.rerouted += 1
                continue
            try:
                send_tensors(sock, tensors, pts, trace=trace,
                             fault_key="nnsq.router", tenant=tenant)
                outs, opts, _rtrace, _ = recv_tensors_ex(sock)
            except (QueryTimeoutError, ConnectionError, OSError):
                # transport failure: the worker is gone or unreachable —
                # drop the socket (stream position unknowable), mark the
                # failure, and re-route.  Stateless requests are safe to
                # re-dispatch by contract.
                link.drop(sock)
                self.membership.report_failure(w)
                tried.add(w.id)
                with self._ledger_lock:
                    self.rerouted += 1
                if attempt + 1 < attempts:
                    # capped exponential backoff + deterministic jitter:
                    # a re-routing fleet must not dogpile the survivors
                    time.sleep(delay_s *
                               (1.0 + 0.25 * self._rng.random()))
                    delay_s = min(delay_s * 2,
                                  self.retry_backoff_cap_ms / 1e3)
                continue
            except (QueryOverloadError, QueryUnavailableError) as exc:
                # typed rejection: the worker is shedding/draining but
                # the connection is fine.  Another worker may have room.
                link.put(sock)
                self.membership.report_success(w)
                if isinstance(exc, QueryExpiredError):
                    raise  # a second worker cannot un-expire a deadline
                last_typed = exc
                tried.add(w.id)
                continue
            except QueryError:
                link.put(sock)
                self.membership.report_success(w)
                raise
            else:
                link.put(sock)
                self.membership.report_success(w)
                return outs, opts, w
        if last_typed is not None:
            raise last_typed
        raise QueryUnavailableError(
            f"{self.name}: no worker answered after {attempts} attempts "
            f"({sorted(tried)} failed)")

    # -- stateful (sticky) serving ------------------------------------------

    def _register_session(self, sess: _Session) -> None:
        with self._sessions_lock:
            self._sessions.setdefault(sess.worker.id, set()).add(sess)
        with self._ledger_lock:
            self.sessions_opened += 1

    def _unregister_session(self, sess: _Session) -> None:
        with self._sessions_lock:
            group = self._sessions.get(sess.worker.id)
            if group is not None:
                group.discard(sess)
        with self._ledger_lock:
            # the session ledger: opened == active + closed, always
            self.sessions_closed += 1

    def session_count(self, worker_id: Optional[str] = None,
                      live_only: bool = False) -> int:
        """Pinned sessions (optionally for one worker).  ``live_only``
        excludes sessions mid-handoff (drain accounting counts those as
        migrating, not live, so a drain never waits on its own
        migrations) and already-broken ones (typed-terminated; nothing
        left to wait for)."""
        with self._sessions_lock:
            if worker_id is not None:
                group = self._sessions.get(worker_id, ())
            else:
                group = [s for g in self._sessions.values() for s in g]
            if live_only:
                return sum(1 for s in group
                           if not s.migrating and not s.broken)
            return len(group)

    def _serve_stateful(self, conn, client: str) -> None:
        sess: Optional[_Session] = None
        try:
            while self._running:
                try:
                    tensors, pts, wtrace, wtenant = recv_tensors_ex(conn)
                except (ConnectionError, OSError):
                    return
                tok = None
                if _spans.enabled:
                    tok = (_spans.span_begin(wtrace[0], wtrace[1])
                           if wtrace is not None
                           else _spans.span_begin(_spans.new_trace_id(), 0))
                fwd_trace = (tok[2], tok[0]) if tok is not None else None
                reply_trace = ((wtrace[0], tok[0])
                               if tok is not None and wtrace is not None
                               else None)
                worker_id = sess.worker.id if sess is not None else ""
                try:
                    try:
                        if pts == PROBE_PTS and sess is None:
                            # negotiation probes are stateless by the
                            # DecodeServer contract: never pin, freely
                            # re-routed
                            outs, opts, w = self._forward(
                                tensors, pts, fwd_trace, tenant=wtenant)
                            worker_id = w.id
                            send_tensors(conn, outs, opts,
                                         trace=reply_trace,
                                         fault_key="nnsq.router")
                            continue
                        if sess is None:
                            sess = self._open_session(conn, client)
                            worker_id = sess.worker.id
                        self._session_step(sess, tensors, pts, fwd_trace,
                                           reply_trace, tenant=wtenant)
                    finally:
                        if tok is not None:
                            _spans.span_end(
                                tok, "nnsq_route", "fleet",
                                args={"client": client,
                                      "worker": worker_id,
                                      "stateful": True})
                except _SessionOver:
                    return
                except QueryError as exc:
                    with sess.lock if sess is not None \
                            else threading.Lock():
                        try:
                            send_error(conn, str(exc), code=exc.code)
                        except OSError:
                            return
                    if sess is not None:
                        # any typed verdict on a pinned session ends it:
                        # the worker-side session died with its conn
                        return
                except Exception as exc:  # noqa: BLE001
                    try:
                        send_error(conn, repr(exc))
                    except OSError:
                        return
        finally:
            if sess is not None:
                self._unregister_session(sess)
                try:
                    sess.sock.close()
                except OSError:
                    pass

    def _open_session(self, conn, client: str) -> _Session:
        """Pin this client connection to a worker (sticky): dedicated
        backend connection, registered for drain accounting."""
        try:
            w = self.membership.pick()
        except NoWorkerAvailable as exc:
            raise QueryUnavailableError(
                f"{self.name}: no worker for a new decode session "
                f"({exc})") from exc
        try:
            link = self._link(w)
            sock = socket.create_connection(
                w.addr, timeout=self.connect_timeout)
            sock.settimeout(self.request_timeout)
            del link
        except (ConnectionError, OSError) as exc:
            self.membership.report_failure(w)
            raise QueryUnavailableError(
                f"{self.name}: worker {w.id} refused the session "
                f"({exc})") from exc
        self.membership.report_success(w)
        sess = _Session(w, sock, conn)
        self._register_session(sess)
        return sess

    def _session_step(self, sess: _Session, tensors, pts, fwd_trace,
                      reply_trace, tenant: Optional[str] = None) -> None:
        """Forward one frame on the pinned connection.  NO replay on
        failure — the worker's session state already advanced an unknown
        number of steps; the client gets the typed ``[SESSION]`` code
        and rebuilds.  The one exception is the typed ``[MIGRATING]``
        verdict, which guarantees the frame was NOT applied: the frame
        re-sends exactly once on the (by then re-pinned) backend socket.
        Each forward holds the session's migration gate, so a frame
        arriving mid-handoff waits and then rides the new worker."""
        for attempt in (0, 1):
            try:
                with sess.mig_lock:
                    send_tensors(sess.sock, tensors, pts, trace=fwd_trace,
                                 fault_key="nnsq.router", tenant=tenant)
                    outs, opts, _rt = recv_tensors_ex(sess.sock)[:3]
            except QueryMigratingError as exc:
                # the worker says the session moved and this frame did
                # not touch state: safe to re-send ONCE after the
                # handoff re-pins the socket.  Persisting = the handoff
                # failed → session-fatal, the fallback old clients know.
                if attempt == 0:
                    continue
                self._break_session(
                    sess, f"decode session migration on worker "
                    f"{sess.worker.id} did not converge ({exc}); "
                    "reconnect and re-prefill")
                raise _SessionOver() from exc
            except (QueryTimeoutError, ConnectionError, OSError) as exc:
                self.membership.report_failure(sess.worker)
                self._break_session(
                    sess, f"decode session on worker {sess.worker.id} "
                    f"broken mid-stream ({exc}); stateful requests "
                    "are never replayed — reconnect and re-prefill")
                raise _SessionOver() from exc
            break
        with sess.lock:
            if sess.broken:
                raise _SessionOver()
            send_tensors(sess.client, outs, opts, trace=reply_trace,
                         fault_key="nnsq.router")
        sess.steps += 1
        self.membership.report_success(sess.worker)

    def _break_session(self, sess: _Session, msg: str) -> None:
        """Terminate one pinned session with the typed ``[SESSION]``
        verdict (idempotent; never a torn client socket).  The ledger
        counts BEFORE the frame goes out: a client reacting to the
        typed error must already see the break in stats()."""
        with sess.lock:
            if sess.broken:
                return
            sess.broken = True
            with self._ledger_lock:
                self.sessions_broken += 1
            try:
                send_error(sess.client, msg, code="SESSION")
            except OSError:
                pass

    # -- live migration ------------------------------------------------------

    def _next_migration_key(self) -> int:
        """A repo-slot key unique across routers sharing one repo server
        (router-name namespace | per-router sequence)."""
        with self._ledger_lock:
            self._mig_seq += 1
            seq = self._mig_seq
        return ((zlib.crc32(self.name.encode()) & 0x7FF) << 20) | \
            (seq & 0xFFFFF)

    def _count_migration(self, result: str, phase: str = "",
                         t0: Optional[float] = None) -> None:
        if result == "noop":
            return  # nothing was attempted (session already gone)
        self._c_migrations.inc(1, result=result)
        if result == "ok" and t0 is not None:
            self._h_migration.observe(time.monotonic() - t0)
        if result != "ok" and phase:
            with self._ledger_lock:
                self.migration_aborts[phase] = \
                    self.migration_aborts.get(phase, 0) + 1

    def _migrate_session(self, sess: _Session) -> bool:
        """Hand one pinned session off to another worker with zero
        client-visible downtime: quiesce (grab the session's migration
        gate — in-flight forward completes, new frames wait) → snapshot
        (``MIGRATE_PTS`` on the source socket publishes the engine state
        into the repo and frees the source slot) → restore
        (``RESUME_PTS`` on a fresh socket to the target rebuilds it) →
        re-pin (swap the backend socket under the gate).

        Returns True when the session was RESOLVED — migrated, or (after
        the source slot was irrevocably released) broken typed — and
        False when it was left untouched, in which case the caller falls
        back to the legacy wait-then-force-break drain path."""
        if not (self.migrate_enabled and self.repo_addr):
            return False
        t0 = time.monotonic()
        # the session_migrate parent span opens before the quiesce so
        # every phase (quiesce/snapshot/restore/resume, plus the worker-
        # side spans via the forwarded trace) nests under it in the
        # merged Perfetto timeline
        tok = (_spans.span_begin(_spans.new_trace_id(), 0)
               if _spans.enabled else None)
        ts = _spans.now_ns() if _spans.enabled else 0
        if not sess.mig_lock.acquire(timeout=self.migrate_timeout_s):
            # quiesce failed: a forward is wedged on the old worker
            self._count_migration("abort", "quiesce")
            if tok is not None:
                _spans.span_end(tok, "session_migrate", "migrate",
                                args={"src": sess.worker.id,
                                      "result": "abort",
                                      "phase": "quiesce"})
            return False
        if ts:
            _spans.record_span("migrate_quiesce", ts,
                               _spans.now_ns() - ts, cat="migrate",
                               args={"worker": sess.worker.id})
        phase = "quiesce"
        snapshot_done = False
        src = sess.worker
        key = self._next_migration_key()
        wire_trace = (tok[2], tok[0]) if tok is not None else None
        result = "noop"
        target = None
        nsock = None
        try:
            with sess.lock:
                if sess.broken:
                    return True  # nothing left to move
            sess.migrating = True
            src.sessions_migrating += 1
            phase = "target"
            try:
                target = self.membership.pick(exclude={src.id})
            except NoWorkerAvailable:
                result = "fallback"
                return False
            ctl = pack_session_control(
                self.repo_addr, key, int(self.migrate_timeout_s * 1e3))
            phase = "snapshot"
            if _faults.enabled:
                _faults.maybe_migrate(f"{self.name}:snapshot:{src.id}")
            ts = _spans.now_ns() if _spans.enabled else 0
            # quiesce + snapshot happen server-side at a tick boundary;
            # an old worker answers the control frame with a plain error
            # (version gate) and we fall back without touching state
            send_tensors(sess.sock, ctl, MIGRATE_PTS,
                         fault_key="nnsq.router", trace=wire_trace)
            recv_tensors_ex(sess.sock)
            snapshot_done = True  # source slot is freed; no way back
            if ts:
                _spans.record_span("migrate_snapshot", ts,
                                   _spans.now_ns() - ts, cat="migrate",
                                   args={"worker": src.id})
            phase = "restore"
            if _faults.enabled:
                _faults.maybe_migrate(f"{self.name}:restore:{target.id}")
            ts = _spans.now_ns() if _spans.enabled else 0
            nsock = socket.create_connection(
                target.addr, timeout=self.connect_timeout)
            nsock.settimeout(self.request_timeout)
            send_tensors(nsock, ctl, RESUME_PTS, fault_key="nnsq.router",
                         trace=wire_trace)
            recv_tensors_ex(nsock)
            if ts:
                _spans.record_span("migrate_restore", ts,
                                   _spans.now_ns() - ts, cat="migrate",
                                   args={"worker": target.id})
            phase = "resume"
            ts = _spans.now_ns() if _spans.enabled else 0
            old_sock = sess.sock
            with self._sessions_lock:
                group = self._sessions.get(src.id)
                if group is not None:
                    group.discard(sess)
                self._sessions.setdefault(target.id, set()).add(sess)
            sess.worker = target
            sess.sock = nsock
            nsock = None  # now owned by the session
            try:
                old_sock.close()
            except OSError:
                pass
            if ts:
                _spans.record_span("migrate_resume", ts,
                                   _spans.now_ns() - ts, cat="migrate",
                                   args={"worker": target.id})
            with self._ledger_lock:
                self.sessions_migrated += 1
            self.membership.report_success(target)
            result = "ok"
            return True
        except Exception as exc:  # noqa: BLE001 — degrade, never hang
            result = "fallback" if not snapshot_done else "abort"
            if nsock is not None:
                try:
                    nsock.close()
                except OSError:
                    pass
            if not snapshot_done:
                # source untouched: the caller's legacy drain path
                # (wait, then force-break typed) still owns the session
                return False
            # point of no return crossed: the source slot is freed and
            # the state sits in the repo — the session cannot continue
            # anywhere, so it degrades to today's typed [SESSION] path
            self._break_session(
                sess, f"decode session handoff {src.id} -> "
                f"{target.id if target else '?'} aborted at {phase} "
                f"({exc}); reconnect and re-prefill")
            try:
                sess.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._repo_clear(key)
            return True
        finally:
            self._count_migration(result, phase, t0)
            if sess.migrating:
                sess.migrating = False
                src.sessions_migrating = max(0, src.sessions_migrating - 1)
            sess.mig_lock.release()
            if tok is not None:
                _spans.span_end(
                    tok, "session_migrate", "migrate",
                    args={"src": src.id,
                          "dst": target.id if target else "",
                          "result": result, "phase": phase,
                          "key": key})

    def _repo_clear(self, key: int) -> None:
        """Best-effort cleanup of an orphaned snapshot slot."""
        from .repo import RemoteTensorRepo

        try:
            repo = RemoteTensorRepo.from_addr(self.repo_addr)
            try:
                repo.clear(key)
            finally:
                repo.close()
        except Exception:  # noqa: BLE001 — cleanup must not mask the abort
            pass

    def migrate_worker_sessions(self, worker_id: str) -> int:
        """Move every live session off ``worker_id``; returns how many
        were resolved (migrated or, past the point of no return, broken
        typed).  Sessions it could not touch stay for the caller's
        legacy drain path."""
        with self._sessions_lock:
            sessions = list(self._sessions.get(worker_id, ()))
        n = 0
        for sess in sessions:
            if sess.broken or sess.migrating:
                continue
            if self._migrate_session(sess):
                n += 1
        return n

    def _handoffs(self, worker_id: str) -> int:
        """Sessions pinned to ``worker_id`` with a handoff in flight."""
        with self._sessions_lock:
            return sum(1 for s in self._sessions.get(worker_id, ())
                       if s.migrating and not s.broken)

    def _migrate_monitor(self) -> None:
        """Watch membership for workers announcing their own drain
        (SIGTERM → probe verdict DRAINING) and migrate their sessions
        before the worker-side deadline force-breaks them — the rolling-
        restart path where nobody calls :meth:`drain_worker`."""
        while not self._mig_stop.wait(self.migrate_check_s):
            try:
                for w in self.membership.workers():
                    if (w.draining or w.state == DRAINING) and \
                            self.session_count(w.id):
                        self.migrate_worker_sessions(w.id)
            except Exception:  # noqa: BLE001 — the monitor must survive
                import logging

                logging.getLogger("nnstreamer_tpu_torch.fleet").exception(
                    "%s: migration monitor pass failed", self.name)

    # -- rebalance -----------------------------------------------------------

    def break_sessions(self, worker_id: str, msg: str,
                       code: str = "SESSION") -> int:
        """Terminate every live session pinned to ``worker_id`` with a
        typed error frame (never a torn socket).  Returns how many."""
        with self._sessions_lock:
            sessions = list(self._sessions.get(worker_id, ()))
        n = 0
        for sess in sessions:
            with sess.lock:
                if sess.broken:
                    continue
                sess.broken = True
                n += 1
                try:
                    send_error(sess.client, msg, code=code)
                except OSError:
                    pass
            for sock in (sess.sock, sess.client):
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        with self._ledger_lock:
            self.sessions_broken += n
        return n

    def drain_worker(self, worker_id: str,
                     deadline_s: Optional[float] = None,
                     migrate: Optional[bool] = None) -> int:
        """Planned removal, migrate-first: stop new work (membership
        drain), live-migrate every pinned session to another worker
        (zero client-visible downtime, token-identical continuation),
        wait out anything unmigratable up to ``deadline_s``, force-break
        stragglers with the typed ``[SESSION]`` code (the fallback path
        — old workers, no repo, no capacity), then eject.  Returns the
        number of force-broken sessions (0 = clean drain)."""
        deadline_s = (self.drain_deadline_s if deadline_s is None
                      else float(deadline_s))
        self.membership.drain(worker_id)
        if migrate is None:
            migrate = self.stateful and self.migrate_enabled \
                and bool(self.repo_addr)
        if migrate:
            self.migrate_worker_sessions(worker_id)
        deadline = time.monotonic() + deadline_s
        # wait out the live sessions, and the handoffs still running (the
        # migration monitor may have taken a session of this worker while
        # the loop above ran): a session mid-handoff is not broken here
        while time.monotonic() < deadline and (
                self.session_count(worker_id, live_only=True)
                or self._handoffs(worker_id)):
            time.sleep(0.02)
        broken = 0
        if self.session_count(worker_id):
            broken = self.break_sessions(
                worker_id,
                f"worker {worker_id} drained: session terminated "
                "(reconnect and re-prefill elsewhere)")
        self.membership.eject(worker_id)
        return broken

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        with self._ledger_lock:
            out = {
                "name": self.name,
                "running": self._running,
                "stateful": self.stateful,
                "offered": self.offered,
                "delivered": self.delivered,
                "shed": dict(self.shed),
                "shed_total": sum(self.shed.values()),
                "rerouted": self.rerouted,
                "sessions_opened": self.sessions_opened,
                "sessions_broken": self.sessions_broken,
                "sessions_closed": self.sessions_closed,
                "sessions_migrated": self.sessions_migrated,
                "migration_aborts": dict(self.migration_aborts),
                "tenants": {t: dict(e) for t, e in self.tenants.items()},
            }
        out["migration"] = {
            "enabled": bool(self.migrate_enabled and self.repo_addr),
            "repo_addr": self.repo_addr,
        }
        out["sessions_active"] = self.session_count()
        out["sessions_migrating"] = (
            out["sessions_active"] - self.session_count(live_only=True))
        # the session ledger: every opened session is either still
        # active or ended exactly once — operators judging a stuck
        # drain read active/migrating per worker below
        out["session_ledger_exact"] = (
            out["sessions_opened"]
            == out["sessions_active"] + out["sessions_closed"])
        with self._sessions_lock:
            out["sessions_by_worker"] = {
                wid: len(group) for wid, group in self._sessions.items()
                if group}
        out["membership"] = self.membership.stats()
        if self.scheduler is not None:
            out["sched"] = self.scheduler.stats()
        return out


class _SessionOver(Exception):
    """Internal: the pinned session ended (typed error already sent)."""
