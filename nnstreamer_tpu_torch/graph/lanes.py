"""Dispatcher lanes: a run-to-completion event-loop runtime for the graph.

The port's copy of the JAX package's ``graph/lanes.py``.  In thread mode
every source, every ``queue`` and ``tensor_dynbatch``, the device reaper and
the watchdog owns a host thread; at many streams a host with one GIL
spends its time switching between them.  This module runs the graph on a
small pool of **run-to-completion event-loop lanes** instead:

- the synchronous pad-push chains already fuse every element between
  *blocking boundaries* (queues, sources) into one call stack; lanes
  schedule those fused chains as cooperative **tasks** instead of parking
  a thread at each boundary;
- sources become pull tasks: each slice pulls up to ``[dispatch]
  quantum`` frames from ``frames()`` and runs the chain downstream to
  completion, then yields the lane;
- a ``queue`` hop becomes a lane-to-lane handoff through per-lane
  **ready rings** (``deque`` appends and pops, atomic under the GIL; a
  condition variable is touched only to wake sleepers).  An idle lane
  **steals** from the fullest ring, so one blocked lane never strands
  ready work;
- a producer that meets a full bounded queue does not park: it *helps*,
  running the consumer's drain task inline (every task has a
  single-executor lock, so run-to-completion holds), and backpressure
  cannot deadlock even on one lane;
- **blocking edges are shunted**: elements that wait on the outside world
  (repo slots, ``appsrc``, the sleep of a live ``videotestsrc``) declare
  ``LANE_BLOCKING``, and their whole fused segment runs on a bounded
  helper pool: a thread named like thread mode's (``src:<name>``,
  ``queue:<name>``) running the element's blocking loop.  A source whose
  ``frames()`` is *measured* to block (consecutive pulls over ``[dispatch]
  block_ms``) is promoted the same way while it runs.

Where the device wait sits differs from the JAX package's.  There a
dispatch returns before the chip finishes, and no lane waits on the
device.  Here the filter's graph replay is enqueued asynchronously too, but
the decoder's device-to-host read waits out the replay (with the GIL
released), on whichever lane runs the decoder's segment, where thread mode
has the queue's thread wait.  The other lanes steal around it.  The device
reaper (``obs/device.py``) calls :func:`device_wakeup` on each completion,
so idle lanes and backpressured producers poll again at once instead of
at the next timeout tick.

Per-thread state is torch's own: ``torch.inference_mode`` is entered inside
the filter's invoke, and a segment may run on any lane, or inline on a
producer's lane through ``help``; nothing assumes that a node's open and
invoke, or two invokes, share an OS thread.

Behavioral contract (the span layer and the recovery ledger prove it):
the Pad/Node API, hook emission points, dispatch enter/exit nesting, queue
depth records, flow arrows across boundaries, restart and quarantine
policies and the watchdog's stall detection are all kept.  Span records
carry the task's *logical* thread name (``src:<name>``, ``queue:<name>``)
through :func:`nnstreamer_tpu_torch.obs.spans.set_tid`, so a flight
snapshot of a lane run renders the Perfetto rows of thread mode, plus one
``lane:<n>`` track a lane with the task slices it ran.

Activation: ``[dispatch] lanes`` / ``NNSTPU_DISPATCH_LANES``: ``0`` (the
default) keeps thread mode unchanged, ``auto`` means ``min(4, cpus)``, an
integer pins the lane count.  ``[dispatch] helpers``, ``block_ms`` and
``quantum`` tune the helper pool, the blocking threshold and the slice.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import weakref
from typing import Dict, List, Optional

from ..buffer import Event
from ..native import TIMEOUT
from ..obs import hooks as _hooks
from ..obs import spans as _spans

_POLL_S = 0.05          # idle-lane ready-ring re-poll interval
_PUSH_WAIT_MS = 20      # timed backpressure push before helping
_SLOW_SLICES = 2        # consecutive slow pulls before a source promotes

# every live runtime, for device_wakeup() (obs/device.py reaper)
_RUNTIMES: "weakref.WeakSet[LaneRuntime]" = weakref.WeakSet()


def configured_lanes() -> int:
    """Lane count from ``[dispatch] lanes`` / ``NNSTPU_DISPATCH_LANES``:
    ``0``/empty = thread-per-element (legacy), ``auto`` = ``min(4,
    cpus)``, an integer pins the count."""
    from ..conf import conf

    val = (conf.get("dispatch", "lanes", "0") or "0").strip().lower()
    if val in ("", "0", "off", "false", "no"):
        return 0
    if val == "auto":
        return max(1, min(4, os.cpu_count() or 1))
    return max(1, int(val))


def device_wakeup() -> None:
    """Called by the device reaper (``obs/device.py``) on each observed
    completion: wake idle lanes and backpressured producers, so work the
    device unblocked is picked up at once, not at the next poll tick."""
    for rt in list(_RUNTIMES):
        rt.notify()


_metrics_lock = threading.Lock()
_metrics: Optional[dict] = None


def _instruments() -> dict:
    global _metrics
    if _metrics is None:
        with _metrics_lock:
            if _metrics is None:
                from ..obs.metrics import REGISTRY

                _metrics = {
                    "tasks": REGISTRY.counter(
                        "nnstpu_lane_tasks_total",
                        "Task slices executed per dispatcher lane",
                        labelnames=("pipeline", "lane")),
                    "steals": REGISTRY.counter(
                        "nnstpu_lane_steals_total",
                        "Task slices stolen from another lane's ready-ring",
                        labelnames=("pipeline", "lane")),
                    "handoffs": REGISTRY.counter(
                        "nnstpu_lane_handoffs_total",
                        "Cross-lane task schedules (lane-to-lane handoffs)",
                        labelnames=("pipeline", "lane")),
                    "depth": REGISTRY.gauge(
                        "nnstpu_lane_ready_depth",
                        "Ready-ring depth per dispatcher lane",
                        labelnames=("pipeline", "lane")),
                    "busy": REGISTRY.gauge(
                        "nnstpu_lane_busy_fraction",
                        "Fraction of the last window a lane spent "
                        "executing task slices",
                        labelnames=("pipeline", "lane")),
                    "promotions": REGISTRY.counter(
                        "nnstpu_lane_promotions_total",
                        "Tasks shunted to the blocking helper pool, "
                        "by reason (hint/measured) and outcome",
                        labelnames=("pipeline", "reason", "result")),
                }
    return _metrics


class LaneTask:
    """One schedulable unit: a fused element chain entered from a source
    pull or a queue drain.  A task runs to completion per slice under a
    single-executor lock; rings hold it at most once (``_armed``)."""

    __slots__ = ("tname", "node", "lane", "done", "promoted", "_run_lock",
                 "_arm_lock", "_armed", "_slow", "__weakref__")

    def __init__(self, tname: str, node, lane: int):
        self.tname = tname
        self.node = node
        self.lane = lane          # ready-ring affinity
        self.done = False
        self.promoted = False
        self._run_lock = threading.Lock()   # one executor at a time
        self._arm_lock = threading.Lock()   # guards _armed
        self._armed = False
        self._slow = 0            # consecutive over-threshold pulls

    def has_work(self) -> bool:
        raise NotImplementedError

    def _slice(self, rt: "LaneRuntime") -> None:
        """Run one quantum; must leave the task consistent on any exit."""
        raise NotImplementedError

    def _blocking_run(self, rt: "LaneRuntime") -> None:
        """Helper-pool body for a promoted task (thread mode's loop, under
        the single-executor lock)."""
        raise NotImplementedError


class SourceTask(LaneTask):
    """Cooperative pull task over ``SourceNode.frames()``: the lane twin of
    ``Pipeline._source_loop``, with its fault, EOS and epoch semantics."""

    __slots__ = ("epoch", "_gen")

    def __init__(self, node, lane: int):
        super().__init__(f"src:{node.name}", node, lane)
        self.epoch = node._epoch
        self._gen = None

    def has_work(self) -> bool:
        return not self.done

    def _finish_eos(self) -> None:
        for pad in self.node.src_pads.values():
            pad.push(_eos())
        self.done = True

    def _slice(self, rt: "LaneRuntime") -> None:
        node, pl = self.node, rt.pipeline
        for _ in range(rt.quantum):
            if self.done:
                return
            try:
                if self._gen is None:
                    self._gen = iter(node.frames())
                t0 = time.perf_counter()
                try:
                    frame = next(self._gen)
                except StopIteration:
                    if node._epoch != self.epoch:
                        self.done = True
                        return
                    self._finish_eos()
                    return
                # blocking detection: a source whose pulls wait again
                # and again (a live source's sleep) is shunted to the
                # helper pool, so it never stalls a lane
                if (time.perf_counter() - t0) * 1e3 >= rt.block_ms:
                    self._slow += 1
                else:
                    self._slow = 0
                if node._epoch != self.epoch:
                    self.done = True    # superseded by restart_source
                    return
                if node.stopped or pl.state != "PLAYING":
                    # mirror _source_loop: every exit except a stale
                    # epoch still EOSes its src pads (a stopping graph's
                    # queues answer SHUTDOWN and drop it harmlessly)
                    self._finish_eos()
                    return
                if _hooks.enabled:
                    _hooks.emit("source_push", pl, node, frame)
                node.push(frame)
            except BaseException as exc:  # noqa: BLE001 - any chain failure
                if node._epoch != self.epoch:
                    self.done = True
                    return
                if (pl.state == "PLAYING" and not node.stopped
                        and pl._source_fault(node, exc)):
                    self._gen = None    # restarted: re-enter frames() fresh
                    continue
                pl.post_error(node, exc)
                self.done = True
                return

    def _blocking_run(self, rt: "LaneRuntime") -> None:
        with self._run_lock:
            while not self.done and rt._running:
                self._slice(rt)


def _eos():
    return Event.eos()


class DrainTask(LaneTask):
    """Queue-consumer task: drives an element's ``_lane_step`` (the
    non-blocking twin of its worker-thread loop).  Armed by the element's
    ``_dispatch`` on every enqueue; lost wakeups are impossible because
    every executor re-checks ``has_work()`` after releasing the run
    lock."""

    __slots__ = ()

    def has_work(self) -> bool:
        q = self.node._q
        return not self.done and q is not None and len(q) > 0

    def _slice(self, rt: "LaneRuntime") -> None:
        if self.node._lane_step(rt) == "done":
            self.done = True

    def _blocking_run(self, rt: "LaneRuntime") -> None:
        del rt
        with self._run_lock:
            self.node._worker()
            self.done = True


class LaneRuntime:
    """The per-pipeline lane pool.  Created by ``Pipeline.start`` when
    ``[dispatch] lanes`` > 0; owns the lane threads, the bounded helper
    pool for blocking tasks, and the task registry."""

    def __init__(self, pipeline, nlanes: int,
                 helpers: Optional[int] = None,
                 block_ms: Optional[float] = None,
                 quantum: Optional[int] = None):
        from ..conf import conf

        self.pipeline = pipeline
        self.nlanes = max(1, int(nlanes))
        self.helpers_max = (int(helpers) if helpers is not None
                            else conf.get_int("dispatch", "helpers", 16))
        self.block_ms = (float(block_ms) if block_ms is not None
                         else conf.get_float("dispatch", "block_ms", 20.0))
        self.quantum = (int(quantum) if quantum is not None
                        else conf.get_int("dispatch", "quantum", 8))
        self._rings: List[collections.deque] = [
            collections.deque() for _ in range(self.nlanes)]
        self._cv = threading.Condition()
        self._idle = 0  # lanes parked in cv.wait (arm skips notify at 0)
        self._threads: List[threading.Thread] = []
        self._helpers: List[threading.Thread] = []
        self._tasks: Dict[str, LaneTask] = {}
        self._tasks_lock = threading.Lock()
        self._next_lane = 0
        self._running = False
        self._tls = threading.local()  # .lane = executing lane index
        # per-lane busy-window accounting behind nnstpu_lane_busy_fraction
        self._busy = [[time.perf_counter(), 0.0] for _ in range(self.nlanes)]
        # hot-path counters flushed to the registry per slice, not per
        # push (a labeled .inc is a dict walk — too heavy per frame)
        self._steals = [0] * self.nlanes
        self._handoffs = [0] * self.nlanes
        self._flushed = [[0, 0] for _ in range(self.nlanes)]
        self._m = _instruments()
        _RUNTIMES.add(self)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._running = True
        for i in range(self.nlanes):
            t = threading.Thread(target=self._lane_loop, args=(i,),
                                 name=f"lane:{i}", daemon=True)
            self._threads.append(t)
            t.start()

    def stop(self, timeout: float = 5.0) -> List[str]:
        """Stop lanes and helpers; returns the names of threads that did
        not exit in time (same abandon-with-warning contract as the
        thread-mode ``Pipeline.stop``)."""
        self._running = False
        with self._cv:
            self._cv.notify_all()
        leaked = []
        deadline = time.monotonic() + timeout
        for t in self._threads + self._helpers:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
            if t.is_alive():
                leaked.append(t.name)
        self._threads.clear()
        self._helpers.clear()
        return leaked

    @property
    def active(self) -> bool:
        return self._running

    def notify(self) -> None:
        with self._cv:
            self._cv.notify_all()

    # -- task registry -------------------------------------------------------

    def _assign_lane(self) -> int:
        lane = self._next_lane % self.nlanes
        self._next_lane += 1
        return lane

    def _segment_blocking(self, node) -> bool:
        """True when any element in the fused chain downstream of
        ``node`` (up to the next decoupling boundary) declares
        ``LANE_BLOCKING`` — the static blocking-boundary rule.  An
        instance-level ``lane_blocking`` attribute overrides the class
        flag in either direction: the segment planner
        (``graph/segments.py``) clears it on decoders whose heavy decode
        moved into the device program, and raises it on decoders left
        running host NMS behind a fused boundary."""
        seen = set()
        stack = [node]
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            hint = getattr(n, "lane_blocking", None)
            blocking = getattr(n, "LANE_BLOCKING", False) if hint is None else hint
            if blocking:
                return True
            if n is not node and getattr(n, "lane_task", None) is not None:
                continue  # next boundary: a fresh task owns that segment
            for pad in n.src_pads.values():
                if pad.peer is not None:
                    stack.append(pad.peer.node)
        return False

    def add_source(self, node) -> SourceTask:
        task = SourceTask(node, self._assign_lane())
        with self._tasks_lock:
            self._tasks[task.tname] = task
        if self._segment_blocking(node):
            self._promote(task, reason="hint")
        else:
            self.arm(task)
        return task

    def add_element(self, node) -> LaneTask:
        task = node.lane_task(self)
        with self._tasks_lock:
            self._tasks[task.tname] = task
        if self._segment_blocking(node):
            self._promote(task, reason="hint")
        return task

    def source_alive(self, name: str) -> bool:
        """Watchdog contract: is the source *executing* (its promoted
        helper thread alive, or its lane task mid-slice — e.g. blocked
        inside ``frames()``, the genuine stall shape)?  A task that is
        merely armed in a ready-ring is starved, not stalled — flagging
        it would restart an innocent source whenever blocked lanes delay
        scheduling."""
        task = self._tasks.get(f"src:{name}")
        if task is None or task.done:
            return False
        if task.promoted:
            return any(t.name == task.tname and t.is_alive()
                       for t in self._helpers)
        return task._run_lock.locked()

    def retire_source(self, name: str, timeout: float = 2.0) -> None:
        """``Pipeline.restart_source`` step 1 under lanes: mark the old
        task done and wait for its current executor to leave (the lane
        analog of joining the old ``src:<name>`` thread) — the caller
        may only re-arm the node's stop event after that, or a slice
        still blocked on it would re-park forever."""
        task = self._tasks.get(f"src:{name}")
        if task is None:
            return
        task.done = True
        if task.promoted:
            for t in list(self._helpers):
                if t.name == task.tname:
                    t.join(timeout=timeout)
                    if not t.is_alive():
                        self._helpers.remove(t)
            return
        if task._run_lock.acquire(timeout=timeout):
            task._run_lock.release()

    def respawn_source(self, node) -> SourceTask:
        """``Pipeline.restart_source`` step 2: schedule a fresh pull
        task for the restarted source."""
        return self.add_source(node)

    def ensure_armed(self, node) -> LaneTask:
        """Queue recovery under lanes: re-create a dead drain task (a
        faulted consumer) and re-arm it against the current backlog.
        Returns the node's live task."""
        task = self._tasks.get(f"queue:{node.name}") \
            or self._tasks.get(f"dynbatch:{node.name}")
        if task is None or task.done:
            task = self.add_element(node)
        if not task.promoted:
            self.arm(task)
        return task

    # -- scheduling ----------------------------------------------------------

    def arm(self, task: LaneTask) -> None:
        """Make ``task`` ready exactly once (ring dedupe via ``_armed``).
        Kept allocation- and metric-free: this runs once per queue push."""
        if task.done or task.promoted or not self._running:
            return
        with task._arm_lock:
            if task._armed:
                return
            task._armed = True
        self._rings[task.lane].append(task)  # deque append: GIL-atomic
        cur = getattr(self._tls, "lane", None)
        if cur is not None and cur != task.lane:
            self._handoffs[task.lane] += 1  # flushed per slice
        if self._idle:
            with self._cv:
                self._cv.notify()
        # a stale idle==0 read is safe: a lane about to park re-checks
        # every ring under the condition lock before waiting

    def _steal(self, idx: int) -> Optional[LaneTask]:
        victims = sorted(
            (i for i in range(self.nlanes) if i != idx),
            key=lambda i: -len(self._rings[i]))
        for i in victims:
            try:
                task = self._rings[i].pop()  # tail steal, owner pops head
            except IndexError:
                continue
            self._steals[idx] += 1  # flushed per slice
            return task
        return None

    def _lane_loop(self, idx: int) -> None:
        ring = self._rings[idx]
        self._tls.lane = idx
        while self._running:
            try:
                task = ring.popleft()
            except IndexError:
                task = self._steal(idx)
            if task is None:
                with self._cv:
                    if not self._running:
                        return
                    if not any(self._rings):
                        self._idle += 1
                        self._cv.wait(_POLL_S)
                        self._idle -= 1
                continue
            self._exec(task, idx)

    def _exec(self, task: LaneTask, idx: int) -> None:
        """Run one slice on lane ``idx`` (run-to-completion), then
        re-arm if work remains.  The post-release ``has_work`` re-check
        is what makes producer-side arming race-free."""
        with task._arm_lock:
            task._armed = False
        if task.done or task.promoted:
            return
        if not task._run_lock.acquire(False):
            # someone else (backpressure help-first, or a stale ring
            # entry) is executing this task; every executor re-checks
            # has_work() after releasing, so dropping it here loses no
            # wakeup — and re-arming would hot-spin against the holder
            return
        t0 = time.perf_counter()
        try:
            self._run_slice(task)
        finally:
            task._run_lock.release()
        dur = time.perf_counter() - t0
        self._account(idx, t0, dur, task)
        if task.done:
            return
        if isinstance(task, SourceTask) and task._slow >= _SLOW_SLICES:
            self._promote(task, reason="measured")
            return
        if task.has_work():
            self.arm(task)

    def _run_slice(self, task: LaneTask) -> None:
        """Execute a slice under the task's *logical* thread identity, so
        span records, flow pairing, and waterfall rows are byte-identical
        to thread mode (``src:<name>`` / ``queue:<name>`` rows)."""
        if not _spans.enabled:
            task._slice(self)
            return
        t0 = _spans.now_ns()
        prev = _spans.set_tid(task.tname)
        try:
            task._slice(self)
        finally:
            _spans.set_tid(prev)
        # the lane:<n> Perfetto track: one slice span per execution,
        # recorded on the lane thread's own identity
        _spans.record_span(task.tname, t0, _spans.now_ns() - t0,
                           cat="lane", trace=(0, 0))

    def _account(self, idx: int, t0: float, dur: float,
                 task: LaneTask) -> None:
        name = self.pipeline.name
        lane = str(idx)
        self._m["tasks"].inc(1, pipeline=name, lane=lane)
        flushed = self._flushed[idx]
        if self._steals[idx] > flushed[0]:
            self._m["steals"].inc(self._steals[idx] - flushed[0],
                                  pipeline=name, lane=lane)
            flushed[0] = self._steals[idx]
        if self._handoffs[idx] > flushed[1]:
            self._m["handoffs"].inc(self._handoffs[idx] - flushed[1],
                                    pipeline=name, lane=lane)
            flushed[1] = self._handoffs[idx]
        win = self._busy[idx]
        win[1] += dur
        now = t0 + dur
        elapsed = now - win[0]
        if elapsed >= 1.0:
            self._m["busy"].set(min(1.0, win[1] / elapsed),
                                pipeline=name, lane=lane)
            win[0] = now
            win[1] = 0.0
        self._m["depth"].set(len(self._rings[idx]), pipeline=name,
                             lane=lane)

    # -- blocking boundaries ---------------------------------------------------

    def _promote(self, task: LaneTask, reason: str) -> None:
        """Shunt a blocking task to the helper pool: a dedicated thread
        named like the legacy one, running the element's classic
        blocking loop.  Bounded by ``[dispatch] helpers`` — past the
        bound the task stays lane-scheduled (degraded, never wrong)."""
        if task.promoted or task.done:
            return
        result = "ok"
        if len(self._helpers) >= self.helpers_max:
            result = "denied"
        else:
            task.promoted = True
            t = threading.Thread(target=task._blocking_run, args=(self,),
                                 name=task.tname, daemon=True)
            self._helpers.append(t)
            t.start()
        self._m["promotions"].inc(1, pipeline=self.pipeline.name,
                                  reason=reason, result=result)
        if _hooks.enabled:
            _hooks.emit("lane_promote", self.pipeline, task.tname,
                        f"{reason}:{result}")
        if result == "denied":
            task._slow = 0  # retry later instead of re-promoting every slice
            self.arm(task)

    def backpressure_push(self, q, item, leaky: str, task: LaneTask) -> int:
        """Timed push into a bounded frame queue from lane context.  On
        timeout (queue full, ``leaky=no``) the producer *helps*: it runs
        the consumer task inline instead of parking the lane — so a full
        queue behaves as backpressure, never as a lane stall or a
        single-lane deadlock."""
        while True:
            status = q.push(item, leaky=leaky, timeout_ms=_PUSH_WAIT_MS)
            if status != TIMEOUT:
                return status
            self.help(task)

    def help(self, task: LaneTask) -> None:
        """Run one slice of ``task`` inline if no one else is executing
        it; otherwise wait briefly for the current executor."""
        if task.done:
            return
        if task._run_lock.acquire(False):
            try:
                self._run_slice(task)
            finally:
                task._run_lock.release()
            if not task.done and task.has_work():
                self.arm(task)
        else:
            with self._cv:
                self._cv.wait(0.005)

    # -- introspection ---------------------------------------------------------

    def stats(self) -> dict:
        with self._tasks_lock:
            tasks = list(self._tasks.values())
        return {
            "lanes": self.nlanes,
            "ready": [len(r) for r in self._rings],
            "tasks": len(tasks),
            "promoted": [t.tname for t in tasks if t.promoted],
            "done": sum(1 for t in tasks if t.done),
            "helpers": len(self._helpers),
        }
