"""``queue``: the thread-decoupling element.

The port of the JAX package's element.  ``_dispatch`` puts each frame or
event into a bounded frame queue (:func:`~nnstreamer_tpu_torch.native.queue.
make_frame_queue`: the C++ queue, or its Python twin with ``[common]
native_runtime=off``) and returns to the upstream thread at once (or blocks while the queue is
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
may come first.  :meth:`Queue.recover` sheds a wedged backlog for
``Pipeline.recover_queue`` (each frame a ``recovery`` drop, events kept in
place) and hands back a fresh worker if the old one died; a
``queue_wedge`` fault (``faults/``) sleeps in the worker loop, so pushes
pile up while pops stop.

Under the dispatcher lanes (``[dispatch] lanes``, ``graph/lanes.py``) the
worker thread gives way to a drain task: :meth:`Queue.lane_task` registers
it, each push arms it on a lane's ready ring, and :meth:`Queue._lane_step`
drains up to ``[dispatch] quantum`` items a slice without blocking.  A
push into a full queue (``leaky=no``) makes the producer run the drain
inline (``LaneRuntime.backpressure_push``), and :meth:`Queue.recover`
re-arms a dead drain task instead of respawning a thread.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from .. import faults as _faults
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
        # lane mode (graph/lanes.py): the drain task in place of the worker
        # thread, and the runtime that schedules it
        self._lane_rt = None
        self._lane_task = None
        self.dropped = 0  # leaky drops over the element's life (survives stop)

    def _ensure_queue(self) -> None:
        if self._q is None:
            self._q = make_frame_queue(self.max_size)

    @property
    def backend_kind(self) -> str:
        """``"native"`` or ``"python"``: which frame queue is active."""
        self._ensure_queue()
        return self._q.impl

    def _dispatch(self, pad: Pad, item) -> None:
        del pad
        self._ensure_queue()
        q = self._q  # stop() may drop the attribute meanwhile
        rt, task = self._lane_rt, self._lane_task
        if rt is not None and task is not None and not task.promoted:
            # lane mode: a full queue is backpressure, never a parked lane;
            # a push that times out makes the producer drain inline
            status = rt.backpressure_push(q, item, self.leaky, task)
        else:
            status = q.push(item, leaky=self.leaky)
        if status in (OK_DROPPED_OLDEST, DROPPED_INCOMING):
            self.dropped += 1
            if _hooks.enabled:
                _hooks.emit("queue_drop", self,
                            "downstream" if status == OK_DROPPED_OLDEST else "upstream")
        if _hooks.enabled:
            _hooks.emit("queue_push", self, len(q))
        if rt is not None and task is not None:
            rt.arm(task)  # the lane-to-lane handoff through a ready ring

    def spawn_threads(self) -> List[threading.Thread]:
        self._ensure_queue()
        self._worker_thread = threading.Thread(target=self._worker, name=f"queue:{self.name}")
        return [self._worker_thread]

    def lane_task(self, rt):
        """Lane-mode registration (``graph/lanes.py``): the drain task that
        takes the worker thread's place."""
        from ..graph.lanes import DrainTask

        self._ensure_queue()
        self._lane_rt = rt
        self._lane_task = DrainTask(f"queue:{self.name}", self, rt._assign_lane())
        return self._lane_task

    def _lane_step(self, rt) -> Optional[str]:
        """One lane slice: drain up to ``rt.quantum`` items without
        blocking, the cooperative twin of :meth:`_worker` with its event,
        fault and error semantics.  ``"done"`` ends the task."""
        q = self._q
        if q is None:
            return "done"
        for _ in range(rt.quantum):
            if _faults.enabled:
                # chaos: queue_wedge sleeps here, as in the worker loop
                _faults.maybe_queue_wedge(self.name)
            status, item = q.pop(0)
            if status == SHUTDOWN:
                return "done"
            if status != OK:
                return None  # drained; the next push arms the task again
            if self._deliver(q, item):
                return "done"
        return None

    def _worker(self) -> None:
        q = self._q  # stop() may drop the attribute while this drains
        while True:
            if _faults.enabled:
                # chaos: a queue_wedge fault sleeps here, so pushes pile up
                # while pops stop
                _faults.maybe_queue_wedge(self.name)
            status, item = q.pop(_POLL_MS)
            if status == SHUTDOWN:
                return
            if status != OK:
                continue  # poll timeout
            if self._deliver(q, item):
                return

    def _deliver(self, q, item) -> bool:
        """One popped item into the downstream chain.  True: the drain is
        over (EOS, or an error posted to the pipeline)."""
        if _hooks.enabled:
            _hooks.emit("queue_pop", self, len(q))
        try:
            if isinstance(item, Event):
                # EOS drains and forwards; caps renegotiates downstream
                # (a NegotiationError there reaches post_error below)
                self._handle_event(self.sink_pads["sink"], item)
                return item.kind == "eos"
            self.push(item)
            return False
        except BaseException as exc:  # noqa: BLE001 - any failure halts the graph
            if self.pipeline is not None:
                self.pipeline.post_error(self, exc)
            return True

    def stats(self) -> dict:
        """Occupancy and drops (GStreamer's ``current-level-buffers`` and
        leaky accounting); safe to call while streaming."""
        q = self._q
        return {
            "impl": q.impl if q is not None else None,
            "capacity": self.max_size,
            "depth": len(q) if q is not None else 0,
            "dropped": self.dropped,
            "leaky": self.leaky,
        }

    def recover(self):
        """Supervised recovery (``Pipeline.recover_queue``): shed the wedged
        backlog (each frame dropped with typed accounting, the in-band
        events, EOS and caps, queued again in order) and hand back a fresh
        worker thread if the old one died (in lane mode, arm the drain task
        again, made anew if it died).  Returns ``(frames_drained,
        new_threads)``."""
        q = self._q
        drained = 0
        if q is not None:
            events = []
            while True:
                status, item = q.pop(0)
                if status != OK:
                    break
                if isinstance(item, Event):
                    events.append(item)
                    continue
                drained += 1
                self.dropped += 1
                if _hooks.enabled:
                    _hooks.emit("queue_drop", self, "recovery")
            for ev in events:
                q.push(ev, leaky="no")
        threads: List[threading.Thread] = []
        rt, task = self._lane_rt, self._lane_task
        if rt is not None and task is not None and not task.promoted:
            # lane mode: no worker thread to respawn; a dead drain task (a
            # faulted consumer) is made again and armed
            self._lane_task = rt.ensure_armed(self)
            return drained, threads
        t = self._worker_thread
        if q is not None and (t is None or not t.is_alive()):
            self._worker_thread = threading.Thread(target=self._worker, name=f"queue:{self.name}")
            threads.append(self._worker_thread)
        return drained, threads

    def interrupt(self) -> None:
        """Wake the worker and any producer blocked on a full queue."""
        if self._q is not None:
            self._q.shutdown()

    def stop(self) -> None:
        if self._q is not None:
            self._q.shutdown()
            self._q = None
        self._lane_rt = None
        self._lane_task = None
        super().stop()
