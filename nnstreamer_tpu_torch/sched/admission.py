"""Admission control: bounded queues, rate limits, typed load shedding.

The port's copy of the JAX package's ``sched/admission.py`` (pure Python).
Without it a serving front door runs unbounded FIFO dispatch: overload
means unbounded queue growth and client-side hangs.  This module makes
overload a *typed, immediate* outcome instead:

- :class:`AdmissionController` — per-tenant in-flight bounds and
  token-bucket rate limits, checked at request receipt.  A rejected
  request raises :class:`OverloadError` carrying a wire code the
  ``NNSQ`` error framing ships to the client (``elements/query.py``
  maps it back to a typed exception — shed, never hang).
- deadline stamping: an admitted item carries an absolute deadline; the
  dispatcher drops items that expired while queued (EXPIRED on the
  wire) — late work is cancelled, not served.
- :class:`PriorityGate` — a contended-resource gate (DecodeServer slot
  assignment): waiters are granted in (priority, FIFO) order, the
  waiting room is bounded, and a full room sheds with a typed error
  instead of parking the connection.

Tenant vs client: rate/queue quotas bind to the *tenant* (host), while
fairness policies see the *client* (one connection/stream) — multiple
streams from one host share a quota but are scheduled individually.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Dict, Optional

# Wire codes: elements/query.py frames these into the NNSQ error message
# and raises the matching typed exception client-side.
CODE_OVERLOAD = "OVERLOAD"
CODE_EXPIRED = "EXPIRED"
CODE_UNAVAILABLE = "UNAVAILABLE"


class OverloadError(RuntimeError):
    """Admission refused (shed) — carries the wire code and reason."""

    def __init__(self, reason: str, msg: str, code: str = CODE_OVERLOAD):
        super().__init__(msg)
        self.reason = reason
        self.code = code


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s, ``burst`` depth."""

    __slots__ = ("rate", "burst", "_tokens", "_t")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else max(1.0, float(rate))
        self._tokens = self.burst
        self._t = now

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self._tokens = min(self.burst, self._tokens + (now - self._t) * self.rate)
        self._t = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


class AdmissionController:
    """Per-tenant bounded admission: in-flight cap + token bucket.

    ``max_queue`` bounds admitted-but-unreleased requests per tenant (the
    per-client bounded queue); ``rate``/``burst`` add a token-bucket rate
    limit (0 = unlimited); ``deadline_ms`` stamps every admitted request
    with an absolute deadline (0 = none).  All methods are thread-safe.
    """

    def __init__(self, max_queue: int = 64, rate: float = 0.0,
                 burst: float = 0.0, deadline_ms: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.max_queue = int(max_queue)
        self.rate = float(rate)
        self.burst = float(burst)
        self.deadline_ms = float(deadline_ms)
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self.admitted = 0
        self.shed_queue_full = 0
        self.shed_rate = 0
        # per-tenant ledger: SLO reports split admitted/shed by tenant
        # without reconstructing it from the metric exposition
        self._by_tenant: Dict[str, Dict[str, int]] = {}

    def _tenant_count(self, tenant: str, key: str) -> None:
        """Caller holds the lock."""
        entry = self._by_tenant.get(tenant)
        if entry is None:
            entry = self._by_tenant[tenant] = {
                "admitted": 0, "shed_queue_full": 0, "shed_rate": 0}
        entry[key] += 1

    def try_admit(self, tenant: str, cost: float = 1.0) -> Optional[float]:
        """Admit one request for ``tenant``; returns the absolute deadline
        (or None) on success, raises :class:`OverloadError` on refusal."""
        now = self._clock()
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n >= self.max_queue:
                self.shed_queue_full += 1
                self._tenant_count(tenant, "shed_queue_full")
                raise OverloadError(
                    "queue_full",
                    f"client {tenant} has {n} requests queued "
                    f"(limit {self.max_queue}); shedding")
            if self.rate > 0:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = self._buckets[tenant] = TokenBucket(
                        self.rate, self.burst, now)
                if not bucket.try_take(now, max(1.0, cost)):
                    self.shed_rate += 1
                    self._tenant_count(tenant, "shed_rate")
                    raise OverloadError(
                        "rate",
                        f"client {tenant} exceeds {self.rate}/s "
                        f"(burst {bucket.burst:g}); shedding")
            self._inflight[tenant] = n + 1
            self.admitted += 1
            self._tenant_count(tenant, "admitted")
        if self.deadline_ms > 0:
            return now + self.deadline_ms / 1e3
        return None

    def release(self, tenant: str) -> None:
        """One admitted request finished (replied, shed, or expired)."""
        with self._lock:
            n = self._inflight.get(tenant, 0)
            if n <= 1:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = n - 1

    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_queue": self.max_queue,
                "rate": self.rate,
                "deadline_ms": self.deadline_ms,
                "inflight_total": sum(self._inflight.values()),
                "admitted": self.admitted,
                "shed_queue_full": self.shed_queue_full,
                "shed_rate": self.shed_rate,
                "tenants": {t: dict(e)
                            for t, e in self._by_tenant.items()},
            }


class PriorityGate:
    """Grant a contended resource to waiters in (priority, FIFO) order.

    The DecodeServer slot-assignment primitive: ``acquire`` parks the
    caller until it is the highest-priority waiter AND ``try_grant``
    (a non-blocking attempt, e.g. ``open_session(timeout=0)`` mapped to
    ``None`` on failure) succeeds.  The waiting room is bounded — a full
    room raises :class:`OverloadError` immediately (typed rejection, not
    a parked connection); an overall timeout raises TimeoutError, same
    surface as the engine's own ``open_session``.

    Grants poll at 50 ms because the freeing event (a slot release) lands
    on the *engine's* condition variable, not this one — cheap relative
    to session lifetimes, and it keeps the gate decoupled from the
    resource it fronts.
    """

    _POLL_S = 0.05

    def __init__(self, max_waiting: int = 16,
                 clock: Callable[[], float] = time.monotonic):
        if max_waiting < 1:
            raise ValueError("max_waiting must be >= 1")
        self.max_waiting = int(max_waiting)
        self._clock = clock
        self._cv = threading.Condition()
        self._heap: list = []  # (-priority, seq, ticket)
        self._seq = itertools.count()
        self.granted = 0
        self.shed_full = 0
        self.timeouts = 0

    def _head(self):
        while self._heap and self._heap[0][2]["dead"]:
            heapq.heappop(self._heap)
        return self._heap[0][2] if self._heap else None

    def waiting(self) -> int:
        with self._cv:
            return sum(1 for *_r, t in self._heap if not t["dead"])

    def acquire(self, priority: int, try_grant: Callable[[], object],
                timeout: Optional[float] = None):
        """Block until granted; returns ``try_grant()``'s result."""
        ticket = {"dead": False}
        with self._cv:
            if sum(1 for *_r, t in self._heap if not t["dead"]) \
                    >= self.max_waiting:
                self.shed_full += 1
                raise OverloadError(
                    "waiters_full",
                    f"{self.max_waiting} sessions already waiting for a "
                    "slot; shedding")
            heapq.heappush(self._heap, (-int(priority), next(self._seq),
                                        ticket))
        deadline = None if timeout is None else self._clock() + timeout
        try:
            with self._cv:
                while True:
                    if self._head() is ticket:
                        res = try_grant()
                        if res is not None:
                            self.granted += 1
                            return res
                    if deadline is not None:
                        left = deadline - self._clock()
                        if left <= 0:
                            self.timeouts += 1
                            raise TimeoutError(
                                f"no slot within {timeout}s "
                                f"({self.waiting() - 1} other waiters)")
                        self._cv.wait(min(self._POLL_S, left))
                    else:
                        self._cv.wait(self._POLL_S)
        finally:
            with self._cv:
                ticket["dead"] = True
                self._head()  # garbage-collect dead heap heads
                self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            return {
                "waiting": sum(1 for *_r, t in self._heap if not t["dead"]),
                "max_waiting": self.max_waiting,
                "granted": self.granted,
                "shed_full": self.shed_full,
                "timeouts": self.timeouts,
            }
