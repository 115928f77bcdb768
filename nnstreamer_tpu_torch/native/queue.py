"""The bounded frame queue behind the ``queue`` element.

The port's copy of the JAX package's ``native/queue.py``: the C++ queue's
binding (:class:`NativeFrameQueue`, ``frame_queue.cpp`` built by
:mod:`nnstreamer_tpu_torch.native`) and its pure-Python twin
(:class:`PyFrameQueue`, condition variable + deque), one surface:

- ``push(item, leaky)`` returns one of the status codes in
  :mod:`nnstreamer_tpu_torch.native`: ``leaky="no"`` blocks while the queue
  is full (backpressure), ``"downstream"`` drops the oldest queued frame,
  ``"upstream"`` drops the incoming frame.  Events are never dropped: a
  full queue blocks them in every mode.
- ``pop(timeout_ms)`` returns ``(status, item)``.
- ``shutdown()`` wakes every waiter; ``dropped`` / ``stats()`` count the
  leaky drops; ``impl`` names the queue (``"native"`` or ``"python"``), and
  the ``queue`` element's ``stats()["impl"]`` says which one it runs.

The native queue keeps the Python objects in a handle table and moves opaque
``uint64`` handles through C++; its blocking waits run outside the GIL.
:func:`make_frame_queue` builds the native queue unless ``[common]
native_runtime`` is off; a failed build raises rather than falling back.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import threading
from typing import Optional, Tuple

from ..buffer import Event
from . import (
    DROPPED_INCOMING,
    EVENT_BIT,
    OK,
    OK_DROPPED_OLDEST,
    SHUTDOWN,
    TIMEOUT,
    load,
)

_LEAK_MODES = {"no": 0, "downstream": 1, "upstream": 2}


class NativeFrameQueue:
    """Bounded blocking queue backed by the C++ runtime library."""

    impl = "native"

    def __init__(self, capacity: int):
        self._lib = load()
        self.capacity = max(1, int(capacity))
        self._q = self._lib.nns_queue_new(self.capacity)
        self._objs = {}
        self._ids = itertools.count(1)
        self._table_lock = threading.Lock()
        self._closed = False
        self.dropped = 0  # leaky-mode drops observed through this binding

    def push(self, item, leaky: str = "no", timeout_ms: int = -1) -> int:
        handle = next(self._ids)
        if isinstance(item, Event):
            handle |= EVENT_BIT
        with self._table_lock:
            self._objs[handle] = item
        dropped = ctypes.c_uint64(0)
        status = self._lib.nns_queue_push(
            self._q, handle, _LEAK_MODES[leaky], timeout_ms, ctypes.byref(dropped))
        if status in (SHUTDOWN, TIMEOUT, DROPPED_INCOMING):
            with self._table_lock:
                self._objs.pop(handle, None)
                if status == DROPPED_INCOMING:
                    self.dropped += 1
        if status == OK_DROPPED_OLDEST:
            with self._table_lock:
                self._objs.pop(dropped.value, None)
                self.dropped += 1
        return status

    def pop(self, timeout_ms: int = -1) -> Tuple[int, Optional[object]]:
        out = ctypes.c_uint64(0)
        status = self._lib.nns_queue_pop(self._q, timeout_ms, ctypes.byref(out))
        if status != OK:
            return status, None
        with self._table_lock:
            return OK, self._objs.pop(out.value)

    def shutdown(self) -> None:
        self._lib.nns_queue_shutdown(self._q)

    def __len__(self) -> int:
        return int(self._lib.nns_queue_len(self._q))

    def stats(self) -> dict:
        return {"depth": len(self), "capacity": self.capacity,
                "dropped": self.dropped}

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.shutdown()
            self._lib.nns_queue_free(self._q)
            self._q = None
            with self._table_lock:
                self._objs.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class PyFrameQueue:
    """Bounded blocking queue of frames and events, in pure Python: the
    native queue's twin, picked by ``[common] native_runtime=off``."""

    impl = "python"

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


def make_frame_queue(capacity: int):
    """The native queue unless ``[common] native_runtime`` is off, then the
    Python twin.  With the switch on, a native build that fails raises
    :class:`~nnstreamer_tpu_torch.native.NativeBuildError`."""
    from . import enabled

    if enabled():
        return NativeFrameQueue(capacity)
    return PyFrameQueue(capacity)
