"""Circuit breaker around backend invokes: fail fast, probe, recover.

The port's copy of the JAX package's ``sched/breaker.py`` (pure Python).
A backend that starts failing (an out-of-memory runtime, a wedged device, a
poisoned model reload) fails every request at full cost: each one still
pays queueing, dispatch and the failing invoke.  The breaker turns a
failing dependency into immediate typed per-request errors
(:class:`BreakerOpenError`, code ``UNAVAILABLE``) and probes for recovery
on its own clock:

- **closed**: requests flow; ``failure_threshold`` *consecutive*
  failures trip the breaker (a success resets the streak).
- **open**: every ``allow()`` is refused for ``reset_timeout_s`` — the
  server replies UNAVAILABLE without touching the backend.
- **half-open**: after the timeout, up to ``half_open_max`` concurrent
  probe requests pass through; one success closes the breaker, one
  failure re-opens it (and restarts the timeout).

Thread-safe; the clock is injectable for tests.  Every live breaker sits
in a weak registry: the pipeline watchdog's overdue-device escalation
(``obs/watchdog.py``) opens them all with :func:`trip_all`.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable

from .admission import CODE_UNAVAILABLE

# Every live breaker, weakly held: the watchdog's overdue-device
# escalation trips them all (fail fast at the serving edge while the
# device is sick) without plumbing a reference through every server.
_ALL: "weakref.WeakSet" = weakref.WeakSet()
_ALL_LOCK = threading.Lock()


def all_breakers():
    """Snapshot of live breakers (weak registry)."""
    with _ALL_LOCK:
        return list(_ALL)


def trip_all(reason: str = "forced") -> int:
    """Force-open every live breaker; returns how many tripped.  The
    watchdog calls this when a device dispatch blows its deadline — new
    requests shed typed UNAVAILABLE instead of queueing behind a wedge,
    and the normal half-open probe path discovers recovery."""
    breakers = all_breakers()
    for b in breakers:
        b.trip(reason)
    return len(breakers)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
# numeric encoding for the state gauge (Prometheus can't label strings)
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class BreakerOpenError(RuntimeError):
    """Refused without invoking: the breaker is open."""

    code = CODE_UNAVAILABLE

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout_s <= 0:
            raise ValueError("reset_timeout_s must be > 0")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_max = max(1, int(half_open_max))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0        # consecutive, while closed
        self._opened_at = 0.0
        self._probes = 0          # in-flight half-open probes
        self.trips = 0            # closed/half-open -> open transitions
        self.rejected = 0         # allow() refusals
        self.forced_trips = 0     # trip() calls (watchdog escalation)
        with _ALL_LOCK:
            _ALL.add(self)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        # caller holds the lock
        if (self._state == OPEN
                and self._clock() - self._opened_at >= self.reset_timeout_s):
            self._state = HALF_OPEN
            self._probes = 0

    def allow(self) -> None:
        """Gate one invoke; raises :class:`BreakerOpenError` when shed.
        Every allowed invoke MUST be followed by exactly one
        ``record_success``/``record_failure`` (use :meth:`call`)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return
            if self._state == HALF_OPEN and self._probes < self.half_open_max:
                self._probes += 1
                return
            self.rejected += 1
            retry = max(0.0, self.reset_timeout_s
                        - (self._clock() - self._opened_at))
            raise BreakerOpenError(
                f"backend circuit breaker {self._state} "
                f"({self._failures} consecutive failures; "
                f"retry in {retry:.1f}s)", retry_after_s=retry)

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._probes = 0
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe failed: straight back to open, fresh timeout
                self._state = OPEN
                self._opened_at = self._clock()
                self._probes = 0
                self.trips += 1
                return
            self._failures += 1
            if self._state == CLOSED \
                    and self._failures >= self.failure_threshold:
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips += 1

    def trip(self, reason: str = "forced") -> None:
        """Force the breaker open NOW (watchdog escalation for an overdue
        device): requests shed until the reset timeout's half-open probe
        confirms the backend is answering again.  Idempotent while open."""
        del reason  # recorded by the caller (obs.recovery)
        with self._lock:
            self.forced_trips += 1
            if self._state == OPEN:
                self._opened_at = self._clock()  # restart the timeout
                return
            self._state = OPEN
            self._opened_at = self._clock()
            self._probes = 0
            self.trips += 1

    def call(self, fn: Callable[[], object]):
        """Run ``fn`` under the breaker: gate, invoke, record outcome."""
        self.allow()
        try:
            out = fn()
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return out

    def stats(self) -> dict:
        with self._lock:
            self._maybe_half_open()
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "trips": self.trips,
                "forced_trips": self.forced_trips,
                "rejected": self.rejected,
                "failure_threshold": self.failure_threshold,
                "reset_timeout_s": self.reset_timeout_s,
            }
