"""The bounded frame queue behind the ``queue`` element.

The port's copy of the JAX package's ``native/queue.py``, pure-Python twin
only (condition variable + deque): the C++ queue is not ported yet, so
:func:`make_frame_queue` always builds :class:`PyFrameQueue`.

- ``push(item, leaky)`` returns one of the status codes in
  :mod:`nnstreamer_tpu_torch.native`: ``leaky="no"`` blocks while the queue
  is full (backpressure), ``"downstream"`` drops the oldest queued frame,
  ``"upstream"`` drops the incoming frame.  Events are never dropped: a
  full queue blocks them in every mode.
- ``pop(timeout_ms)`` returns ``(status, item)``.
- ``shutdown()`` wakes every waiter; ``dropped`` / ``stats()`` count the
  leaky drops.
"""

from __future__ import annotations

import collections
import threading
from typing import Optional, Tuple

from ..buffer import Event
from . import DROPPED_INCOMING, OK, OK_DROPPED_OLDEST, SHUTDOWN, TIMEOUT


class PyFrameQueue:
    """Bounded blocking queue of frames and events."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._buf = collections.deque()
        self._cv = threading.Condition()
        self._shutdown = False
        self.dropped = 0  # leaky-mode drops

    def push(self, item, leaky: str = "no", timeout_ms: int = -1) -> int:
        is_event = isinstance(item, Event)
        timeout = None if timeout_ms < 0 else timeout_ms / 1000.0
        with self._cv:
            if len(self._buf) >= self.capacity and not self._shutdown:
                if leaky == "downstream" and not is_event:
                    for i, queued in enumerate(self._buf):
                        if not isinstance(queued, Event):
                            del self._buf[i]
                            self._buf.append(item)
                            self.dropped += 1
                            self._cv.notify_all()
                            return OK_DROPPED_OLDEST
                elif leaky == "upstream" and not is_event:
                    self.dropped += 1
                    return DROPPED_INCOMING
                if not self._cv.wait_for(
                    lambda: self._shutdown or len(self._buf) < self.capacity, timeout
                ):
                    return TIMEOUT
            if self._shutdown:
                return SHUTDOWN
            self._buf.append(item)
            self._cv.notify_all()
            return OK

    def pop(self, timeout_ms: int = -1) -> Tuple[int, Optional[object]]:
        timeout = None if timeout_ms < 0 else timeout_ms / 1000.0
        with self._cv:
            if not self._cv.wait_for(lambda: self._shutdown or bool(self._buf), timeout):
                return TIMEOUT, None
            if not self._buf:
                return SHUTDOWN, None
            item = self._buf.popleft()
            self._cv.notify_all()
            return OK, item

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def __len__(self) -> int:
        with self._cv:
            return len(self._buf)

    def stats(self) -> dict:
        with self._cv:
            return {"depth": len(self._buf), "capacity": self.capacity,
                    "dropped": self.dropped}

    def close(self) -> None:
        self.shutdown()


def make_frame_queue(capacity: int) -> PyFrameQueue:
    """The frame queue for a ``queue`` element (the Python twin: the port
    has no native queue yet)."""
    return PyFrameQueue(capacity)
