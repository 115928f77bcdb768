"""Host staging: the shared buffer pool and the events that gate
host→device copies.

The port's counterpart of the JAX package's ``pool.py``:

- :class:`BufferPool`: a bounded pool of host tensors keyed by ``(shape,
  dtype, pinned)``.  :meth:`BufferPool.lease` hands out a tensor marked
  ``pool_fresh`` (True when it allocated, False when it recycled); a
  lease meant for the card is page-locked (``pin=True``), so its
  host→device copy runs asynchronously.  A lease returns to the free list
  when its last view is dropped (a finalizer on a per-lease buffer owner
  that every view keeps alive), or early through
  :meth:`BufferPool.recycle`.  The free list is bounded by
  ``max_per_class`` buffers a class and ``max_bytes`` in all; a recycle
  that would overflow evicts the oldest free buffers first.  The batch
  elements (``tensor_batch``, ``tensor_dynbatch``) assemble their batches
  in leases.
- :func:`fence`: a copy that reads a leased buffer asynchronously (the
  upload's ``non_blocking`` host→device copy) registers the CUDA event
  recorded after it; :meth:`BufferPool.lease` waits for that event before
  it hands the buffer out again to be rewritten.  On the CPU a copy is
  complete when it returns, there is no event, and ``fence`` does nothing.
- :class:`WireStager`: ping-pong staging per tensor index for the
  upload's copies of frames that are not leases: ``depth`` (default 2)
  page-locked host tensors, each with the event of the copy that last
  read it; a slot is rewritten only after its event has completed.
- :func:`mark_ready` / :func:`wait_ready`: a device tensor made by an
  asynchronous copy on a side stream carries that copy's event.  Every
  node's dispatch of a frame calls :func:`wait_ready` on its tensors before
  ``process`` (``graph/node.py``): the current stream waits on the event,
  and ``record_stream`` keeps the caching allocator from reusing the block
  before the consumer's work is done.

Why two mechanisms rewrite pinned buffers after an event, and not one: a
lease is written once by a batch element and then belongs to its frame,
which may be held anywhere downstream, so it comes back only when its
last view dies and may be leased again at once, to any element; it must
carry its fence with it.  The stager's slots never leave the upload: it
alternates ``depth`` of them, so staging frame k waits for the copy of
frame k - depth, which has most often finished, and never for the copy
of frame k - 1.  Staging through the pool instead would hand the upload back the
buffer whose copy it has just issued (the free list gives the most
recently returned buffer, for warm pages) and wait for that copy on
every frame, and it would cost a buffer owner and a finalizer per frame.
The upload tells the two apart by ``_pool_lease`` and copies a lease as
it is.

Knobs (env ``NNSTPU_POOL_*`` > ini ``[pool]`` > defaults): ``enabled``,
``max_per_class``, ``max_bytes``.  The default pool publishes
``nnstpu_pool_*`` metrics on the port's registry (``obs/metrics.py``).
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import torch

from .spec import numpy_dtype, torch_dtype

_READY = "_nns_ready"  # attribute of a device tensor: its copy's event

DEFAULT_MAX_PER_CLASS = 4
DEFAULT_MAX_BYTES = 64 << 20  # free (pooled) bytes


def _conf_int(key: str, default: int) -> int:
    from .conf import conf

    try:
        return conf.get_int("pool", key, default)
    except ValueError:
        return default


def _conf_bool(key: str, default: bool) -> bool:
    from .conf import conf

    try:
        return conf.get_bool("pool", key, default)
    except ValueError:
        return default


class BufferPool:
    """A bounded pool of recycled host tensors.

    The bounds hold for the free list only (a leased tensor belongs to its
    frames): at most ``max_per_class`` free buffers a ``(shape, dtype,
    pinned)`` class and ``max_bytes`` free bytes in all.  A recycle that
    would overflow evicts the oldest free buffers first, then drops the
    incoming one if it still does not fit; every drop counts as an
    eviction.
    """

    def __init__(self, max_per_class: Optional[int] = None, max_bytes: Optional[int] = None,
                 registry=None):
        if max_per_class is None:
            max_per_class = (_conf_int("max_per_class", DEFAULT_MAX_PER_CLASS)
                             if _conf_bool("enabled", True) else 0)
        if max_bytes is None:
            max_bytes = _conf_int("max_bytes", DEFAULT_MAX_BYTES)
        self.max_per_class = int(max_per_class)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._free: Dict[tuple, deque] = {}
        self._order: deque = deque()  # the free list's classes in recycle order
        self._fences: Dict[int, List] = {}  # id(raw) -> events of copies reading it
        self._free_bytes = 0
        self._leased_bytes = 0
        self.hits = self.misses = self.evictions = self.recycles = 0
        self._metrics = None
        if registry is not None:
            self._metrics = {
                "hits": registry.counter("nnstpu_pool_hits_total",
                                         "Buffer-pool leases served from the free list"),
                "misses": registry.counter("nnstpu_pool_misses_total",
                                           "Buffer-pool leases that allocated a fresh buffer"),
                "evictions": registry.counter("nnstpu_pool_evictions_total",
                                              "Pooled buffers dropped by the free-list bounds"),
                "recycles": registry.counter("nnstpu_pool_recycles_total",
                                             "Buffers returned to the pool (finalizer or "
                                             "explicit)"),
                "leased": registry.gauge("nnstpu_pool_leased_bytes",
                                         "Bytes currently leased out of the pool"),
                "free": registry.gauge("nnstpu_pool_free_bytes",
                                       "Bytes currently idle on the pool free list"),
            }

    # -- lease / recycle ----------------------------------------------------

    @staticmethod
    def _key(shape, dtype, pin: bool) -> tuple:
        return tuple(int(d) for d in shape), str(numpy_dtype(dtype)), bool(pin)

    def lease(self, shape: Sequence[int], dtype, pin: bool = False) -> torch.Tensor:
        """A writable host tensor of ``shape`` and ``dtype`` (page-locked
        with ``pin``): recycled when its class has a free one, allocated
        otherwise.  It returns to the pool when its last view is dropped."""
        key = self._key(shape, dtype, pin)
        raw = None
        with self._lock:
            dq = self._free.get(key)
            if dq:
                raw = dq.pop()  # the most recently used: warm pages
                self._order.remove(key)
                self._free_bytes -= raw.nbytes
                self.hits += 1
            else:
                self.misses += 1
        self._m_inc("hits" if raw is not None else "misses")
        fresh = raw is None
        if fresh:
            raw = torch.empty(key[0], dtype=torch_dtype(numpy_dtype(dtype)), pin_memory=pin)
            if raw.nbytes == 0:
                raw.pool_fresh = True
                return raw  # nothing to pool
        else:
            # no rewrite while a copy issued from the buffer's last lease
            # still reads it
            self._wait_fences(raw)
        # a per-lease owner of the memory: every view of the lease keeps it
        # alive, and its finalizer is the last view's drop
        shim = (ctypes.c_byte * raw.nbytes).from_address(raw.data_ptr())
        arr = torch.frombuffer(shim, dtype=torch.uint8).view(raw.dtype).view(raw.shape)
        arr.pool_fresh = fresh
        arr._pool_lease = (self, raw)  # fence() finds the pool here
        arr._pool_finalizer = weakref.finalize(shim, self._give_back, raw, key)
        with self._lock:
            self._leased_bytes += raw.nbytes
        self._publish()
        return arr

    def recycle(self, arr: torch.Tensor) -> None:
        """Return a lease now: only where no view of ``arr`` can still be
        read (a staging loop's own buffer).  Idempotent."""
        fin = getattr(arr, "_pool_finalizer", None)
        if fin is not None:
            fin()

    def _give_back(self, raw: torch.Tensor, key: tuple) -> None:
        nbytes = raw.nbytes
        evicted = 0
        with self._lock:
            self._leased_bytes -= nbytes
            self.recycles += 1
            dq = self._free.setdefault(key, deque())
            if len(dq) >= self.max_per_class:
                evicted += 1  # the class is full: drop the incoming buffer
                self._fences.pop(id(raw), None)  # freeing needs no wait
            else:
                while self._order and self._free_bytes + nbytes > self.max_bytes:
                    evicted += self._evict_oldest_locked()
                if nbytes > self.max_bytes:
                    evicted += 1  # can never fit
                    self._fences.pop(id(raw), None)
                    if not dq:
                        self._free.pop(key, None)
                else:
                    dq.append(raw)
                    self._order.append(key)
                    self._free_bytes += nbytes
            self.evictions += evicted
        self._m_inc("recycles")
        if evicted:
            self._m_inc("evictions", evicted)
        self._publish()

    def _evict_oldest_locked(self) -> int:
        key = self._order.popleft()
        dq = self._free[key]
        victim = dq.popleft()  # the coldest of its class
        if not dq:
            del self._free[key]
        self._free_bytes -= victim.nbytes
        self._fences.pop(id(victim), None)
        return 1

    # -- fences --------------------------------------------------------------

    def _fence_raw(self, raw: torch.Tensor, event: Any) -> None:
        with self._lock:
            self._fences.setdefault(id(raw), []).append(event)

    def _wait_fences(self, raw: torch.Tensor) -> None:
        with self._lock:
            events = self._fences.pop(id(raw), None)
        for event in events or ():
            event.synchronize()

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses, "evictions": self.evictions,
                    "recycles": self.recycles, "leased_bytes": self._leased_bytes,
                    "free_bytes": self._free_bytes,
                    "free_buffers": sum(len(d) for d in self._free.values()),
                    "classes": len(self._free)}

    def _m_inc(self, name: str, amount: float = 1.0) -> None:
        if self._metrics is not None:
            self._metrics[name].inc(amount)

    def _publish(self) -> None:
        m = self._metrics
        if m is None:
            return
        with self._lock:
            leased, free = self._leased_bytes, self._free_bytes
        m["leased"].set(leased)
        m["free"].set(free)


_default_pool: Optional[BufferPool] = None
_default_lock = threading.Lock()


def default_pool() -> BufferPool:
    """The pool the port's elements share, made on first use from conf; it
    publishes ``nnstpu_pool_*`` on the port's metrics registry."""
    global _default_pool
    if _default_pool is None:
        with _default_lock:
            if _default_pool is None:
                from .obs.metrics import REGISTRY

                _default_pool = BufferPool(registry=REGISTRY)
    return _default_pool


def reset_default_pool() -> None:
    """Drop the default pool, so the next use reads conf again."""
    global _default_pool
    with _default_lock:
        _default_pool = None


def fence(t: Any, event: Any) -> bool:
    """Register ``event`` (a CUDA event recorded after a copy that reads
    the lease ``t``) with its pool: the pool waits for it before the
    buffer is leased again.  False where there is no event (a CPU copy is
    done when it returns) or ``t`` is not a lease (a view of one is not:
    only the lease itself carries its pool)."""
    lease = getattr(t, "_pool_lease", None)
    if event is None or lease is None:
        return False
    pool, raw = lease
    pool._fence_raw(raw, event)
    return True


class WireStager:
    """Ping-pong staging for host→device copies.

    ``stage(idx, x)`` copies host tensor ``x`` into one of ``depth`` slots
    for tensor index ``idx``, alternating slots; ``track(idx, event)``
    registers the event of the copy issued from the slot just staged.  A
    slot is rewritten only after that event has completed.
    """

    def __init__(self, depth: int = 2, pin: bool = False):
        self._depth = max(1, int(depth))
        self._pin = pin
        self._slots: Dict[int, dict] = {}
        self.last_alloc = 0  # 1 if the last stage() allocated its slot, else 0

    def stage(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        slot = self._slots.get(idx)
        if slot is None:
            slot = self._slots[idx] = {"bufs": [None] * self._depth,
                                       "busy": [None] * self._depth, "turn": 0}
        k = slot["turn"] % self._depth
        slot["turn"] += 1
        slot["last"] = k
        event = slot["busy"][k]
        if event is not None:
            event.synchronize()  # the copy from this slot is done: rewrite it
            slot["busy"][k] = None
        buf = slot["bufs"][k]
        self.last_alloc = 0
        if buf is None or tuple(buf.shape) != tuple(x.shape) or buf.dtype != x.dtype:
            buf = slot["bufs"][k] = torch.empty(x.shape, dtype=x.dtype, pin_memory=self._pin)
            self.last_alloc = 1
        buf.copy_(x)
        return buf

    def track(self, idx: int, event) -> None:
        """Gate the last staged slot of ``idx`` on ``event``."""
        slot = self._slots.get(idx)
        if slot is not None and "last" in slot and event is not None:
            slot["busy"][slot["last"]] = event

    def reset(self) -> None:
        """Drop every slot (renegotiation, stop) once the copies still
        reading them have completed."""
        for slot in self._slots.values():
            for event in slot["busy"]:
                if event is not None:
                    event.synchronize()
        self._slots.clear()


def mark_ready(t: torch.Tensor, event) -> torch.Tensor:
    """Attach the event after which the device tensor ``t`` holds its data
    (the asynchronous copy that made it)."""
    if event is not None:
        setattr(t, _READY, event)
    return t


def wait_ready(t):
    """Before a consumer's first read of ``t``: its current stream waits for
    the copy that made ``t``, and the allocator keeps ``t``'s block until
    that stream's work is done.  Anything else passes unchanged."""
    event = getattr(t, _READY, None)
    if event is not None:
        stream = torch.cuda.current_stream(t.device)
        stream.wait_event(event)
        t.record_stream(stream)
    return t
