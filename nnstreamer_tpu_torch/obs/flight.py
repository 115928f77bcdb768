"""Flight recorder: bounded per-thread ring buffers for span records.

The port's copy of the JAX package's ``obs/flight.py``.  The storage
layer under :mod:`.spans` — the "black box" that is always cheap to write
and only ever read at snapshot time (a crash dump, a Perfetto export, a
test's assertion).  Design constraints, in order:

- **append must never block or allocate beyond the record tuple**: each
  thread writes only its own pre-allocated ring (discovered via
  ``threading.local``), so there is no lock and no contention on the
  per-frame path — "lock-free-ish" in the CPython sense (the GIL makes
  the two stores atomic enough for a profiler);
- **bounded**: a ring holds ``capacity`` records per thread; older
  records are overwritten, and the overflow count is reported so a
  truncated snapshot is never mistaken for a complete one;
- **drained at snapshot time**: :meth:`snapshot` copies every ring under
  the registration lock and merges by timestamp.  A snapshot racing live
  appends may catch a ring mid-wrap; the worst case is one stale record,
  acceptable for tracing (same contract as GstShark's ring tracers).

Record layout (fixed-position tuples, written by :mod:`.spans`):

    (ph, ts_ns, dur_ns, tid, name, cat, trace_id, span_id, parent_id, args)

``ph`` is the Chrome trace-event phase letter where one maps 1:1
("X" complete span, "i" instant, "C" counter, "s"/"f" flow start/end);
``ts_ns``/``dur_ns`` are ``time.perf_counter_ns()`` values — the hook
bus clock (``obs/hooks.py``), shared by every producer.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

DEFAULT_CAPACITY = 16384  # records per thread (overridable via [obs] flight_records)


class FlightRecorder:
    """Per-thread bounded rings + a snapshot that merges them by time."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"flight recorder capacity must be >= 1, got {capacity}")
        self._tls = threading.local()
        self._lock = threading.Lock()
        # every ring ever created: (buffer, [next_index], thread_name).
        # Rings outlive their threads so a snapshot still sees a finished
        # worker's records.
        self._rings: List[Tuple[list, list, str]] = []

    def _ring(self):
        ring = getattr(self._tls, "ring", None)
        if ring is None:
            ring = ([None] * self.capacity, [0], threading.current_thread().name)
            self._tls.ring = ring
            with self._lock:
                self._rings.append(ring)
        return ring

    def append(self, rec: tuple) -> None:
        """Record one tuple into the calling thread's ring (never blocks)."""
        buf, idx, _ = self._ring()
        i = idx[0]
        buf[i % self.capacity] = rec
        idx[0] = i + 1

    def snapshot(self) -> List[tuple]:
        """Copy of every thread's retained records, merged by timestamp."""
        with self._lock:
            rings = list(self._rings)
        out: List[tuple] = []
        for buf, idx, _ in rings:
            n = idx[0]
            if n <= self.capacity:
                recs = buf[:n]
            else:  # wrapped: oldest retained record first
                start = n % self.capacity
                recs = buf[start:] + buf[:start]
            out.extend(r for r in recs if r is not None)
        out.sort(key=lambda r: r[1])
        return out

    def clear(self) -> None:
        """Drop retained records (rings stay registered for their threads)."""
        with self._lock:
            for buf, idx, _ in self._rings:
                idx[0] = 0
                for i in range(len(buf)):
                    buf[i] = None

    def stats(self) -> dict:
        with self._lock:
            rings = list(self._rings)
        retained = sum(min(idx[0], self.capacity) for _, idx, _ in rings)
        dropped = sum(max(0, idx[0] - self.capacity) for _, idx, _ in rings)
        return {
            "capacity": self.capacity,
            "threads": len(rings),
            "records": retained,
            "dropped": dropped,
        }
