"""``queue``: the thread-decoupling element.

The port of the JAX package's element.  ``_dispatch`` puts each frame or
event into a bounded :class:`~nnstreamer_tpu_torch.native.queue.PyFrameQueue`
and returns to the upstream thread at once (or blocks while the queue is
full: backpressure); a worker thread of its own, spawned by
``Pipeline.start`` through :meth:`Queue.spawn_threads`, drains it into the
downstream chain.  In the canonical topology
``… ! tensor_upload ! queue ! tensor_filter ! …`` the source's thread
stages and uploads frame N+1 while the queue's thread runs frame N.

Leak modes follow GStreamer's: ``no`` (backpressure), ``downstream`` (drop
the oldest queued frame), ``upstream`` (drop the incoming frame); in-band
events (EOS, caps) are never dropped.  The hook bus sees each push and pop
with the depth after it (``queue_push``/``queue_pop``) and each leaky drop
with its reason (``queue_drop``).  As in the JAX package, a push becomes
poppable before its ``queue_push`` fires, so a fast consumer's ``queue_pop``
may come first.  Not ported yet: the dispatcher-lane mode (``lane_task``)
and ``recover()`` (with its ``recovery`` drops).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from ..buffer import Event
from ..graph.node import Node, Pad
from ..graph.registry import register_element
from ..native import DROPPED_INCOMING, OK, OK_DROPPED_OLDEST, SHUTDOWN
from ..native.queue import make_frame_queue
from ..obs import hooks as _hooks

_POLL_MS = 100  # the worker wakes this often, so a shutdown is never missed


@register_element("queue")
class Queue(Node):
    def __init__(self, name: Optional[str] = None, max_size_buffers: int = 200,
                 leaky: str = "no"):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.max_size = int(max_size_buffers)
        if leaky not in ("no", "downstream", "upstream"):
            raise ValueError(f"unknown leaky mode {leaky!r}")
        self.leaky = str(leaky)
        self._q = None
        self._worker_thread: Optional[threading.Thread] = None
        self.dropped = 0  # leaky drops over the element's life (survives stop)

    def _ensure_queue(self) -> None:
        if self._q is None:
            self._q = make_frame_queue(self.max_size)

    def _dispatch(self, pad: Pad, item) -> None:
        del pad
        self._ensure_queue()
        q = self._q  # stop() may drop the attribute meanwhile
        status = q.push(item, leaky=self.leaky)
        if status in (OK_DROPPED_OLDEST, DROPPED_INCOMING):
            self.dropped += 1
            if _hooks.enabled:
                _hooks.emit("queue_drop", self,
                            "downstream" if status == OK_DROPPED_OLDEST else "upstream")
        if _hooks.enabled:
            _hooks.emit("queue_push", self, len(q))

    def spawn_threads(self) -> List[threading.Thread]:
        self._ensure_queue()
        self._worker_thread = threading.Thread(target=self._worker, name=f"queue:{self.name}")
        return [self._worker_thread]

    def _worker(self) -> None:
        q = self._q  # stop() may drop the attribute while this drains
        sink = self.sink_pads["sink"]
        while True:
            status, item = q.pop(_POLL_MS)
            if status == SHUTDOWN:
                return
            if status != OK:
                continue  # poll timeout
            if _hooks.enabled:
                _hooks.emit("queue_pop", self, len(q))
            try:
                if isinstance(item, Event):
                    # EOS drains and forwards; caps renegotiates downstream
                    # (a NegotiationError there reaches post_error below)
                    self._handle_event(sink, item)
                    if item.kind == "eos":
                        return
                else:
                    self.push(item)
            except BaseException as exc:  # noqa: BLE001 - any failure halts the graph
                if self.pipeline is not None:
                    self.pipeline.post_error(self, exc)
                return

    def stats(self) -> dict:
        """Occupancy and drops (GStreamer's ``current-level-buffers`` and
        leaky accounting); safe to call while streaming."""
        q = self._q
        return {
            "capacity": self.max_size,
            "depth": len(q) if q is not None else 0,
            "dropped": self.dropped,
            "leaky": self.leaky,
        }

    def interrupt(self) -> None:
        """Wake the worker and any producer blocked on a full queue."""
        if self._q is not None:
            self._q.shutdown()

    def stop(self) -> None:
        if self._q is not None:
            self._q.shutdown()
            self._q = None
        super().stop()
