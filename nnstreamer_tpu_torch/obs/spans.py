"""Per-frame span tracing: where did *this* frame spend its time.

The port's copy of the JAX package's ``obs/spans.py``.  The tracers
(:mod:`.tracers`) answer "how slow is the pipeline on average"; this module
answers the per-frame question:

- every frame gets a ``trace_id``/``span_id`` context stamped into
  ``Frame.meta`` at the source (a **mutable list**, so the shallow
  ``with_tensors`` meta copy shares it across payload swaps, queue hops,
  and thread boundaries — the GstMeta discipline);
- hook-bus callbacks (:class:`SpanTracer`) open/close spans at dispatch
  enter/exit, record queue push/pop occupancy, and mark every pad push
  as a potential cross-thread **flow**: a push records a flow-start, and
  whichever thread next touches the frame records the flow-finish —
  pairs that never left their thread are dropped at export time (on the
  port's canonical path the flow crosses the ``queue``, from the source's
  thread to the queue's);
- coalescing elements stamp the combined frame with a fresh span whose
  **parent links** name every constituent frame's span
  (:func:`merge_context`; its callers, ``tensor_mux`` and
  ``tensor_dynbatch``, are not ported yet);
- records land in a bounded per-thread ring (:class:`~.flight.
  FlightRecorder`) — zero cost when disabled (the ``enabled`` module
  flag is one load + truth test, same discipline as ``obs/hooks.py``);
- :func:`chrome_trace` renders a snapshot as Chrome trace-event JSON
  (loads in Perfetto / ``chrome://tracing``, one row per element
  thread, flow arrows following each frame across threads);
  :func:`waterfall` renders the same data as a plain-text per-frame
  timeline for terminals and bug reports.

Spans are host time: a dispatch span of ``tensor_filter`` covers the
enqueue of its graph replay, and the device work only where profiling
makes the filter wait for it (``utils/profiling.py``).

Activation: ``NNSTPU_TRACERS=spans`` (conf-driven, like every tracer),
``pipeline.attach_tracer("spans")``, or :func:`enable`.  Ring capacity
comes from ``NNSTPU_FLIGHT_RECORDS`` / ini ``[obs] flight_records``.
Not ported yet: the logical thread names of the dispatcher lanes
(``set_tid``), and the trace lookups of the query wire and tail
forensics (``new_trace_id``, ``records_for_trace``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from .flight import DEFAULT_CAPACITY, FlightRecorder
from .tracers import Tracer

# Frame.meta keys.  The context value is a mutable list
# [trace_id, span_id, pending_flow_id, pending_flow_tid] shared by every
# shallow meta copy of the same logical frame.
META_KEY = "obs_span"
PARENTS_KEY = "obs_span_parents"

# record phases (Chrome trace-event letters where the mapping is 1:1)
PH_COMPLETE = "X"
PH_INSTANT = "i"
PH_COUNTER = "C"
PH_FLOW_START = "s"
PH_FLOW_END = "f"

# The fast-path gate for sites outside the hook bus (merge_context): one
# module-attribute load + truth test when span tracing is off.
enabled = False

_lock = threading.Lock()
_active = 0        # SpanTracer refcount
_manual = False    # explicit enable() (serving surfaces without a pipeline)

_ids = itertools.count(1)
# trace ids start at a per-process random offset so two processes'
# traces stay distinct in a merged view
_trace_ids = itertools.count(
    (int.from_bytes(os.urandom(4), "little") << 20) | 1)
_flow_ids = itertools.count(1)

_recorder = FlightRecorder()
_tls = threading.local()

now_ns = time.perf_counter_ns  # the one clock (see obs/hooks.py)


def _tid() -> str:
    return threading.current_thread().name


def _rec(ph, ts, dur, name, cat, trace_id, span_id, parent_id, args) -> None:
    _recorder.append((ph, ts, dur, _tid(), name, cat,
                      trace_id, span_id, parent_id, args))


# -- activation --------------------------------------------------------------

def configured_flight_records() -> int:
    """Ring capacity per thread: ``NNSTPU_FLIGHT_RECORDS`` (short
    spelling) over ini ``[obs] flight_records`` over the default."""
    val = os.environ.get("NNSTPU_FLIGHT_RECORDS")
    if val is None:
        from ..conf import conf

        val = conf.get("obs", "flight_records", "")
    try:
        cap = int(val) if val not in (None, "") else DEFAULT_CAPACITY
    except ValueError:
        return DEFAULT_CAPACITY
    return cap if cap > 0 else DEFAULT_CAPACITY


def _activate(capacity: Optional[int] = None) -> None:
    global enabled, _active, _recorder
    with _lock:
        if _active == 0 and not _manual and capacity \
                and capacity != _recorder.capacity:
            _recorder = FlightRecorder(capacity)
        _active += 1
        enabled = True


def _deactivate() -> None:
    global enabled, _active
    with _lock:
        _active = max(0, _active - 1)
        if _active == 0 and not _manual:
            enabled = False


def enable(capacity: Optional[int] = None) -> None:
    """Turn span recording on without a pipeline tracer (explicit spans
    of code outside a pipeline)."""
    global enabled, _manual, _recorder
    with _lock:
        if _active == 0 and not _manual and capacity \
                and capacity != _recorder.capacity:
            _recorder = FlightRecorder(capacity)
        _manual = True
        enabled = True


def disable() -> None:
    global enabled, _manual
    with _lock:
        _manual = False
        if _active == 0:
            enabled = False


def reset() -> None:
    """Hard reset: disabled, fresh empty recorder (test isolation)."""
    global enabled, _manual, _active, _recorder
    with _lock:
        _active = 0
        _manual = False
        enabled = False
        _recorder = FlightRecorder(_recorder.capacity)


def snapshot() -> List[tuple]:
    """Drain the flight recorder: every retained record, time-ordered."""
    return _recorder.snapshot()


def clear() -> None:
    _recorder.clear()


def recorder_stats() -> dict:
    return _recorder.stats()


# -- trace context -----------------------------------------------------------

def new_context() -> list:
    """Fresh [trace_id, span_id, flow_id, flow_tid] context (frame root)."""
    return [next(_trace_ids), next(_ids), 0, None]


def context_of(item) -> Optional[list]:
    meta = getattr(item, "meta", None)
    return meta.get(META_KEY) if meta is not None else None


def _consume_flow(ctx: list, ts: int) -> None:
    """Close the frame's pending flow here.  Only a hop that actually
    changed threads becomes a flow-finish record — same-thread pushes
    leave an unpaired start that export drops."""
    fid = ctx[2]
    if fid:
        tid = _tid()
        if ctx[3] != tid:
            _recorder.append((PH_FLOW_END, ts, 0, tid, "frame", "dataflow",
                              ctx[0], fid, 0, None))
        ctx[2] = 0
        ctx[3] = None


def merge_context(frames: Iterable, meta: dict, name: str) -> None:
    """Stamp a coalesced frame (dynbatch batch, mux collection round) with
    a fresh span context carrying **parent links** to every constituent
    frame's span.  Constituents' pending cross-thread flows terminate at
    the coalesce point, so Perfetto draws each source stream's arrow into
    the batch."""
    if not enabled:
        return
    ts = now_ns()
    parents: List[Tuple[int, int]] = []
    trace_id = 0
    for f in frames:
        ctx = context_of(f)
        if ctx is None:
            continue
        if not trace_id:
            trace_id = ctx[0]
        parents.append((ctx[0], ctx[1]))
        _consume_flow(ctx, ts)
    if not parents:
        return
    sid = next(_ids)
    meta[META_KEY] = [trace_id, sid, 0, None]
    meta[PARENTS_KEY] = tuple(parents)
    _rec(PH_INSTANT, ts, 0, name, "coalesce", trace_id, sid, parents[0][1],
         {"parents": [f"{t:x}/{s:x}" for t, s in parents]})


# -- explicit spans ----------------------------------------------------------

def current() -> Optional[Tuple[int, int]]:
    """(trace_id, span_id) the calling thread is currently inside, if any."""
    return getattr(_tls, "cur", None)


def span_begin(trace_id: int = 0, parent_id: int = 0) -> tuple:
    """Open an explicit span and make it the thread's current context
    (children recorded via :func:`record_span` nest under it).  Returns
    an opaque token for :func:`span_end`."""
    sid = next(_ids)
    prev = getattr(_tls, "cur", None)
    _tls.cur = (trace_id, sid)
    return (sid, now_ns(), trace_id, parent_id, prev)


def span_end(token: tuple, name: str, cat: str = "span",
             args: Optional[dict] = None) -> int:
    sid, t0, trace_id, parent_id, prev = token
    _rec(PH_COMPLETE, t0, now_ns() - t0, name, cat,
         trace_id, sid, parent_id, args)
    _tls.cur = prev
    return sid


def record_span(name: str, t0_ns: int, dur_ns: int, cat: str = "span",
                trace: Optional[Tuple[int, int]] = None,
                args: Optional[dict] = None) -> int:
    """Record a completed span.  ``trace`` is (trace_id, parent_span_id);
    when omitted the thread's current context (an enclosing
    :func:`span_begin`) provides it."""
    if trace is None:
        trace = current() or (0, 0)
    sid = next(_ids)
    _rec(PH_COMPLETE, t0_ns, dur_ns, name, cat, trace[0], sid, trace[1], args)
    return sid


def record_instant(name: str, cat: str = "span",
                   trace: Optional[Tuple[int, int]] = None,
                   args: Optional[dict] = None) -> None:
    if trace is None:
        trace = current() or (0, 0)
    _rec(PH_INSTANT, now_ns(), 0, name, cat, trace[0], next(_ids), trace[1],
         args)


# -- the tracer --------------------------------------------------------------

class SpanTracer(Tracer):
    """Hook-bus tracer feeding the flight recorder.

    Dispatch enter/exit become complete ("X") spans per element — nested
    naturally, because a pad push runs the downstream chain inside the
    upstream dispatch.  A per-thread stack supplies parent span ids; the
    frame's stamped context supplies the trace id.  Queue push/pop become
    counter tracks, queue drops and source pushes instants, and every pad
    push opens a flow that closes on whichever thread touches the frame
    next.
    """

    name = "spans"

    def __init__(self, registry=None, capacity: Optional[int] = None):
        super().__init__(registry)
        self._capacity = capacity
        self._stacks = threading.local()

    def _install(self) -> None:
        cap = self._capacity if self._capacity is not None \
            else configured_flight_records()
        _activate(cap)
        self._connect("source_push", self._on_source_push)
        self._connect("pad_push", self._on_pad_push)
        self._connect("dispatch_enter", self._on_dispatch_enter)
        self._connect("dispatch_exit", self._on_dispatch_exit)
        self._connect("queue_push", self._on_queue_push)
        self._connect("queue_pop", self._on_queue_pop)
        self._connect("queue_drop", self._on_queue_drop)
        self._connect("error", self._on_error)

    def stop(self) -> None:
        was_active = bool(self._conns)
        super().stop()
        if was_active:
            _deactivate()

    # -- hook callbacks ------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._stacks, "stack", None)
        if stack is None:
            stack = self._stacks.stack = []
        return stack

    def _on_source_push(self, pipeline, node, frame) -> None:
        if pipeline is not self._pipeline:
            return
        ctx = frame.meta.get(META_KEY)
        if ctx is None:
            ctx = frame.meta[META_KEY] = new_context()
        _rec(PH_INSTANT, now_ns(), 0, f"{node.name}.push", "source",
             ctx[0], ctx[1], 0, None)

    def _on_pad_push(self, pad, item) -> None:
        if pad.node.pipeline is not self._pipeline:
            return
        ctx = context_of(item)
        if ctx is None:
            return
        ts = now_ns()
        _consume_flow(ctx, ts)
        fid = next(_flow_ids)
        ctx[2] = fid
        ctx[3] = _tid()
        _recorder.append((PH_FLOW_START, ts, 0, ctx[3], "frame", "dataflow",
                          ctx[0], fid, 0, None))

    def _on_dispatch_enter(self, node, pad, item, t0) -> None:
        if node.pipeline is not self._pipeline:
            return
        ctx = context_of(item)
        if ctx is not None:
            _consume_flow(ctx, t0)
        self._stack().append((next(_ids), t0, ctx))

    def _on_dispatch_exit(self, node, pad, item, dur_ns) -> None:
        if node.pipeline is not self._pipeline:
            return
        stack = self._stack()
        if not stack:
            return  # tracer attached mid-dispatch: no matching enter
        sid, t0, ctx = stack.pop()
        if stack:
            parent = stack[-1][0]
        else:
            parent = ctx[1] if ctx else 0
        trace_id = ctx[0] if ctx else 0
        _rec(PH_COMPLETE, t0, dur_ns, node.name, "dispatch",
             trace_id, sid, parent, None)

    def _on_queue_push(self, node, depth) -> None:
        if node.pipeline is self._pipeline:
            _rec(PH_COUNTER, now_ns(), 0, f"{node.name} depth", "queue",
                 0, 0, 0, depth)

    _on_queue_pop = _on_queue_push

    def _on_queue_drop(self, node, reason) -> None:
        if node.pipeline is self._pipeline:
            _rec(PH_INSTANT, now_ns(), 0, f"{node.name} drop", "queue",
                 0, next(_ids), 0, {"reason": reason})

    def _on_error(self, pipeline, node, exc) -> None:
        if pipeline is self._pipeline:
            _rec(PH_INSTANT, now_ns(), 0, "pipeline_error", "error",
                 0, next(_ids), 0,
                 {"node": node.name if node else "?", "error": repr(exc)})

    def summary(self) -> dict:
        return recorder_stats()


# -- exporters ---------------------------------------------------------------

def _flow_pairs(records) -> Dict[int, Tuple[tuple, tuple]]:
    """Flow ids whose start AND finish were retained on different threads."""
    starts: Dict[int, tuple] = {}
    ends: Dict[int, tuple] = {}
    for r in records:
        if r[0] == PH_FLOW_START:
            starts[r[7]] = r
        elif r[0] == PH_FLOW_END:
            ends[r[7]] = r
    return {fid: (s, ends[fid]) for fid, s in starts.items()
            if fid in ends and s[3] != ends[fid][3]}


def chrome_trace(records: Optional[List[tuple]] = None, pid: int = 0,
                 process_name: str = "nnstreamer_tpu_torch") -> dict:
    """A snapshot as a Chrome trace-event JSON object (the ``traceEvents``
    array format): load the dumped file in Perfetto (ui.perfetto.dev) or
    ``chrome://tracing``.  One tid row per recorded thread, "X" spans
    with µs ts/dur, counter tracks for queue depth, and "s"/"f" flow
    arrows for every frame hop that crossed threads."""
    if records is None:
        records = snapshot()
    events: List[dict] = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    tids: Dict[str, int] = {}

    def tid_for(name: str) -> int:
        t = tids.get(name)
        if t is None:
            t = tids[name] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": t, "args": {"name": name}})
        return t

    flows = _flow_pairs(records)
    for ph, ts, dur, tname, name, cat, trace_id, sid, parent, args in records:
        base = {"pid": pid, "tid": tid_for(tname), "ts": ts / 1e3,
                "name": name, "cat": cat}
        if ph == PH_COMPLETE:
            ev_args = {"trace_id": f"{trace_id:x}", "span_id": f"{sid:x}",
                       "parent_id": f"{parent:x}"}
            if args:
                ev_args.update(args)
            base.update(ph="X", dur=dur / 1e3, args=ev_args)
        elif ph == PH_INSTANT:
            ev_args = {"trace_id": f"{trace_id:x}"}
            if args:
                ev_args.update(args)
            base.update(ph="i", s="t", args=ev_args)
        elif ph == PH_COUNTER:
            base.update(ph="C", args={"depth": args})
        elif ph in (PH_FLOW_START, PH_FLOW_END):
            if sid not in flows:
                continue  # never crossed a thread (or half evicted)
            base.update(ph=ph, id=sid)
            if ph == PH_FLOW_END:
                base["bp"] = "e"
        else:  # pragma: no cover — unknown phase from a future producer
            continue
        events.append(base)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def waterfall(records: Optional[List[tuple]] = None, limit: int = 16) -> str:
    """Plain-text per-frame waterfall: one block per trace id, spans and
    instants indented by start time relative to the trace's first record
    (the terminal-friendly view of the same flight snapshot)."""
    if records is None:
        records = snapshot()
    by_trace: Dict[int, List[tuple]] = {}
    for r in records:
        if r[0] in (PH_COMPLETE, PH_INSTANT) and r[6]:
            by_trace.setdefault(r[6], []).append(r)
    lines: List[str] = []
    traces = sorted(by_trace.items(), key=lambda kv: kv[1][0][1])
    for trace_id, recs in traces[:limit]:
        t0 = min(r[1] for r in recs)
        span = max(r[1] + r[2] for r in recs) - t0
        lines.append(f"trace {trace_id:x}  ({len(recs)} records, "
                     f"{span / 1e6:.3f} ms)")
        for ph, ts, dur, tname, name, cat, _, _, _, args in recs:
            off = (ts - t0) / 1e6
            dur_s = f"{dur / 1e6:8.3f}ms" if ph == PH_COMPLETE else "        -"
            extra = ""
            if args and "parents" in args:
                extra = f"  <- {len(args['parents'])} parent span(s)"
            lines.append(f"  +{off:9.3f}ms {dur_s}  {name:<24} "
                         f"{cat:<9} [{tname}]{extra}")
    if len(traces) > limit:
        lines.append(f"... {len(traces) - limit} more trace(s) truncated")
    return "\n".join(lines)


# self-registration with the tracer registry (obs/__init__ imports this
# module, so ``NNSTPU_TRACERS=spans`` / attach_tracer("spans") always
# resolve)
from .tracers import TRACERS  # noqa: E402

TRACERS[SpanTracer.name] = SpanTracer
