"""Device lane: device timing, capture accounting, memory gauges.

The port's copy of the JAX package's ``obs/device.py``.  Every other tracer
measures **host** wall time, but a CUDA launch is asynchronous:
``backend.invoke`` returns when the replay is *enqueued*, not when the
card has finished it, so a host span attributes the device's work to
whichever element first waits on the result.  This module is the device
lane of the obs subsystem:

- :class:`DeviceTracer` (``NNSTPU_TRACERS=device``) stamps each filter
  dispatch with a **completion probe**.  While a device tracer is live,
  ``tensor_filter`` records a ``torch.cuda.Event`` on its stream before
  the invoke and another right after it (:func:`record_begin`,
  :func:`record_end`); the ``device_dispatch`` hook then hands the pair to
  a bounded queue drained by a background *reaper* thread
  (``device:cuda``), which waits on the second event
  (``event.synchronize()``) and records a ``device_exec`` span with the
  enqueue→done time into the flight recorder on its own track, with a
  flow arrow from the host dispatch span.  The span's ``device_ms`` arg is
  the event pair's ``elapsed_time``: the card's own time for the dispatch
  (the static-input copy, the replay and the output clones), without the
  wait behind earlier work that the enqueue→done time includes.  Outputs
  on the CPU complete at once.  The queue is bounded, so a wedged card
  can never grow host memory without bound: overflow drops the probe and
  counts it.
- :func:`record_compile` is the sink for the backend's capture-LRU events
  (``backends/torch_backend.py``: a capture is a ``miss``, a cached
  capture selected again a ``hit``, an entry aged out an ``evict``):
  ``nnstpu_compile_total{result=...}`` counters, a capture wall-time
  histogram, the FLOPs and bytes of each capture, a ``compile`` span when
  span tracing is active, and the ``compile`` hook.  Counters are fed
  whether a tracer is attached or not.  :func:`memory_info` is a
  capture's memory footprint, which the backend keeps on the capture's
  cost-registry entry for the deep-profiling lane's ledger
  (``obs/profiler.py``).
- :func:`register_memory_gauges` / :func:`device_memory_snapshot` sample
  the caching allocator of each card (``torch.cuda.memory_stats()`` and
  ``torch.cuda.mem_get_info()``) as ``nnstpu_device_memory_bytes`` gauges
  at scrape time and as a dict for error flight dumps.  A process that
  has not used the card contributes nothing.
- the **utilization lane** (:mod:`.util`): every reaped dispatch is
  joined with its capture's registered cost (the backend stamps a cost
  fingerprint per capture) to compute the achieved TFLOP/s and GB/s and
  the MFU over the event pair's time (``nnstpu_mfu{device,node,bucket}``)
  and a roofline class (span args and
  ``nnstpu_roofline_dispatches_total``); enqueue→done coverage feeds the
  windowed ``nnstpu_device_busy_fraction{device}`` gauge, and idle gaps of
  at least ``[obs] device_idle_gap_ms`` become ``device_idle`` flight
  spans on the device track (reason: ``wire`` under a slow probe regime,
  ``host_dispatch`` when nothing was enqueued, ``queue_wait`` otherwise).

:func:`oldest_inflight` says how old the oldest dispatch still executing
is (the watchdog's overdue-device verdict reads it).  Each completion the
reaper observes wakes the dispatcher lanes (``graph/lanes.device_wakeup``),
so idle lanes and backpressured producers poll again at once.

A batch-sharded dispatch (the dispatch mesh, ``backends/sharded.py``) is
reaped shard by shard (:meth:`DeviceTracer._reap_sharded`): the backend
names each shard's device (``last_shards``, ``<type>:<id>`` of the mesh
position) and, on the card, an event pair around each of the shard's
graph segments; each shard gets a ``device_exec`` span on its own
``device:<label>`` track and its own ``nnstpu_device_exec_seconds
{device=...}`` series, with ``flops / ndev`` of the capture's cost for its
MFU.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import hooks as _hooks
from . import spans
from . import util as _util
from .metrics import REGISTRY, MetricsRegistry
from .tracers import Tracer

now_ns = time.perf_counter_ns

# Seconds-unit buckets for device execution and capture time: 50 µs to
# 2.5 s, plus a long tail for cold captures.
DEVICE_EXEC_BUCKETS_S = (
    5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5,
)
COMPILE_BUCKETS_S = DEVICE_EXEC_BUCKETS_S + (5.0, 10.0, 30.0, 60.0)

DEFAULT_PROBE_CAPACITY = 1024

# In-flight dispatch registry (probe id -> (t0_ns, element name)), shared
# by every active DeviceTracer.
_inflight_lock = threading.Lock()
_inflight: Dict[int, Tuple[int, str]] = {}

# Live DeviceTracers: while any is attached, a filter brackets each
# dispatch on the card with a CUDA event pair.
_timing_lock = threading.Lock()
_event_timing = 0


def event_timing() -> bool:
    """True while a :class:`DeviceTracer` is attached anywhere."""
    return _event_timing > 0


def record_begin(backend):
    """The first event of a dispatch's pair, recorded on the current stream
    of the backend's device when that is a card, with that stream; None
    otherwise."""
    import torch

    dev = getattr(backend, "device", None)
    if not isinstance(dev, torch.device) or dev.type != "cuda":
        return None
    stream = torch.cuda.current_stream(dev)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev, stream


def record_end(begin, outs):
    """``(begin, end)`` with ``end`` recorded right after the invoke on the
    stream that ran it, or None for a dispatch whose outputs live on the
    host (they are complete when the invoke returns)."""
    import torch

    if begin is not None:
        ev, stream = begin
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        return ev, end
    head = outs[0] if isinstance(outs, (tuple, list)) and outs else outs
    if isinstance(head, torch.Tensor) and head.is_cuda:
        end = torch.cuda.Event()
        end.record(torch.cuda.current_stream(head.device))
        return None, end
    return None


def oldest_inflight() -> Optional[Tuple[int, str]]:
    """(enqueue ts_ns, element name) of the oldest dispatch whose device
    completion has not been observed yet, or None.  Only meaningful while a
    :class:`DeviceTracer` is attached (otherwise nothing registers)."""
    with _inflight_lock:
        if not _inflight:
            return None
        return min(_inflight.values())


def configured_probe_capacity() -> int:
    """Completion-probe queue bound: ``NNSTPU_OBS_DEVICE_PROBE_QUEUE`` /
    ini ``[obs] device_probe_queue`` over the default."""
    from ..conf import conf

    try:
        cap = conf.get_int("obs", "device_probe_queue", DEFAULT_PROBE_CAPACITY)
    except ValueError:
        return DEFAULT_PROBE_CAPACITY
    return cap if cap > 0 else DEFAULT_PROBE_CAPACITY


# -- capture accounting ------------------------------------------------------

# Compile-phase attribution (thread-local): the pipeline marks its start
# (negotiation and the warmup phase) so that those captures land on the
# "warmup" Perfetto track and nnstpu_compile_seconds splits by
# phase={warmup,serving}.
_phase_tls = threading.local()


def set_compile_phase(phase: Optional[str]) -> None:
    """Mark the calling thread's captures as ``phase`` ("warmup") or
    restore the default ("serving") with None."""
    _phase_tls.phase = phase


def compile_phase() -> str:
    return getattr(_phase_tls, "phase", None) or "serving"


def _compile_metrics(registry: MetricsRegistry):
    return (
        registry.counter(
            "nnstpu_compile_total",
            "Backend executable-cache events (hit/miss/persist_hit/evict)",
            labelnames=("result",),
        ),
        registry.histogram(
            "nnstpu_compile_seconds",
            "Wall time spent building backend executables (seconds; "
            "persist_hit reconstructs included), split by compile phase",
            labelnames=("phase",),
            buckets=COMPILE_BUCKETS_S,
        ),
        registry.counter(
            "nnstpu_compile_flops_total",
            "Sum of cost_analysis() flops over compiled executables",
        ),
        registry.counter(
            "nnstpu_compile_bytes_total",
            "Sum of cost_analysis() bytes accessed over compiled executables",
        ),
    )


def memory_info(entry, parameter_bytes: int = 0) -> dict:
    """A captured graph's device-memory footprint, the counterpart of the
    JAX package's ``memory_info`` over an executable's
    ``memory_analysis()``, under its kinds: ``argument_bytes`` (the
    parameters, ``parameter_bytes``, and the static inputs, ``input_bytes``),
    ``output_bytes`` (the static outputs), ``temp_bytes`` (the graph's
    private pool, ``entry.pool_bytes``, less its outputs; absent when the
    pool was not measured), and ``alias_bytes`` and ``generated_code_bytes``
    at 0 (a replay aliases nothing and owns no code)."""
    import torch

    def nbytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors or ()
                   if isinstance(t, torch.Tensor))

    inputs = nbytes(getattr(entry, "static_in", ()))
    outputs = nbytes(getattr(entry, "static_out", ()))
    info = {"argument_bytes": int(parameter_bytes) + inputs,
            "parameter_bytes": int(parameter_bytes), "input_bytes": inputs,
            "output_bytes": outputs, "alias_bytes": 0, "generated_code_bytes": 0}
    pool = getattr(entry, "pool_bytes", None)
    if pool is not None:
        info["temp_bytes"] = max(0, int(pool) - outputs)
    return info


def record_compile(backend, key, result: str, dur_ns: int = 0,
                   info: Optional[dict] = None,
                   registry: Optional[MetricsRegistry] = None) -> None:
    """Account one capture-LRU event (called by the torch backend), with
    the JAX package's metric names: a capture counts as that package's
    compile.  Feeds the ``nnstpu_compile_*`` metrics, records a
    ``compile`` span when span tracing is active, and emits the
    ``compile`` hook.  Never raises: accounting must not take a capture
    down."""
    try:
        phase = compile_phase()
        counters, hist, flops_c, bytes_c = _compile_metrics(
            registry if registry is not None else REGISTRY)
        counters.inc(1, result=result)
        if result == "miss":
            hist.observe(dur_ns / 1e9, phase=phase)
            if info:
                if (info.get("flops") or 0) > 0:
                    flops_c.inc(info["flops"])
                if (info.get("bytes") or 0) > 0:
                    bytes_c.inc(info["bytes"])
        if spans.enabled and result == "miss":
            args = {"key": repr(key), "backend": type(backend).__name__,
                    "result": result, "phase": phase}
            if info:
                args.update(info)
            if phase == "warmup":
                # the dedicated "warmup" track, never inside a frame's trace
                spans._recorder.append((
                    spans.PH_COMPLETE, now_ns() - dur_ns, dur_ns, "warmup",
                    "compile", "compile", 0, next(spans._ids), 0, args))
            else:
                spans.record_span("compile", now_ns() - dur_ns, dur_ns,
                                  cat="compile", trace=(0, 0), args=args)
        if _hooks.enabled:
            _hooks.emit("compile", backend, key, result, dur_ns, info or {})
    except Exception:  # noqa: BLE001
        import logging

        logging.getLogger("nnstreamer_tpu_torch.obs").exception(
            "compile accounting failed")


# -- device memory gauges ----------------------------------------------------

# The JAX package's memory_stats() keys, each read from the caching
# allocator of the card:
#   bytes_in_use           <- memory_stats()["allocated_bytes.all.current"]
#   peak_bytes_in_use      <- memory_stats()["allocated_bytes.all.peak"]
#   pool_bytes             <- memory_stats()["reserved_bytes.all.current"]
#                             (what the allocator holds, CUDA graph pools
#                             included)
#   bytes_limit            <- mem_get_info()[1] (the card's memory)
#   bytes_reservable_limit <- mem_get_info()[0] + pool_bytes (what the
#                             allocator could hold now: the free memory
#                             and its own pool)
#   largest_alloc_size     <- none: the caching allocator keeps no mark of
#                             its largest single request (the nearest,
#                             "requested_bytes.all.peak", is a sum), so the
#                             key is absent, as the JAX package skips any
#                             key its allocator lacks.
_MEMORY_KEYS = (
    "bytes_in_use",
    "peak_bytes_in_use",
    "bytes_limit",
    "bytes_reservable_limit",
    "pool_bytes",
)

_STAT_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "pool_bytes": "reserved_bytes.all.current",
}


def _tensor_device_label(t) -> str:
    """``cuda:<ordinal>`` / ``cpu:0`` of a tensor's placement, ``host`` for
    numpy and other non-tensor outputs."""
    import torch

    if isinstance(t, torch.Tensor):
        return f"{t.device.type}:{t.device.index or 0}"
    return "host"


# Peak-watermark deltas: the instantaneous gauges miss transient spikes
# between scrapes, so every snapshot folds the observed high-water mark into
# a per-device watermark that the peak gauge drains at scrape time.
_peak_lock = threading.Lock()
_peak_watermarks: Dict[str, int] = {}


def _observe_peaks(snapshot: Dict[str, Dict[str, int]]) -> None:
    with _peak_lock:
        for dev, stats in snapshot.items():
            seen = max(stats.get("peak_bytes_in_use", 0),
                       stats.get("bytes_in_use", 0))
            if seen > _peak_watermarks.get(dev, 0):
                _peak_watermarks[dev] = seen


def reset_peak_watermarks() -> None:
    """Drop every tracked watermark (test isolation)."""
    with _peak_lock:
        _peak_watermarks.clear()


def _cards() -> List[int]:
    """Ordinals of the cards, once this process uses CUDA; else none (a
    scrape never creates a CUDA context)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return list(range(torch.cuda.device_count()))


def device_memory_snapshot(devices=None) -> Dict[str, Dict[str, int]]:
    """Per-card allocator snapshot (``{"cuda:0": {"bytes_in_use": ...}}``)
    for scrape collectors and error flight dumps; ``{}`` on a host without
    a card in use.  ``devices``: card ordinals (default: every card).
    Every snapshot also feeds the watermarks behind
    ``nnstpu_device_memory_peak_bytes``."""
    import torch

    ordinals = _cards() if devices is None else list(devices)
    out: Dict[str, Dict[str, int]] = {}
    for i in ordinals:
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        kept = {k: int(stats[v]) for k, v in _STAT_KEYS.items() if v in stats}
        kept["bytes_limit"] = int(total)
        kept["bytes_reservable_limit"] = int(free) + kept.get("pool_bytes", 0)
        out[f"cuda:{i}"] = {k: kept[k] for k in _MEMORY_KEYS if k in kept}
    _observe_peaks(out)
    return out


def register_memory_gauges(registry: Optional[MetricsRegistry] = None,
                           devices=None):
    """Sample per-card memory into ``nnstpu_device_memory_bytes`` gauges at
    every scrape (a registry collector: pull-style, no poller).  Returns
    the collector handle for ``remove_collector``.

    Also exports ``nnstpu_device_memory_peak_bytes{device}``: the highest
    ``peak_bytes_in_use`` observed since the last scrape.  After each read
    the tracked watermark resets to zero and the allocator's peak too
    (``torch.cuda.reset_peak_memory_stats``), which makes the series a
    high-water mark between scrapes instead of a maximum since start."""
    import torch

    registry = registry if registry is not None else REGISTRY
    gauge = registry.gauge(
        "nnstpu_device_memory_bytes",
        "Per-device allocator stats (bytes), sampled at scrape time",
        labelnames=("device", "kind"),
    )
    peak_gauge = registry.gauge(
        "nnstpu_device_memory_peak_bytes",
        "Per-device peak bytes in use observed since the last scrape "
        "(watermark drained at read; allocator peak reset where supported)",
        labelnames=("device",),
    )

    def collect():
        snapshot = device_memory_snapshot(devices)
        for dev, stats in snapshot.items():
            for kind, val in stats.items():
                gauge.set(val, device=dev, kind=kind)
        with _peak_lock:
            drained = {dev: _peak_watermarks.pop(dev, 0) for dev in snapshot}
        for dev, peak in drained.items():
            peak_gauge.set(peak, device=dev)
            torch.cuda.reset_peak_memory_stats(int(dev.partition(":")[2]))

    return registry.add_collector(collect)


# -- the tracer --------------------------------------------------------------

class DeviceTracer(Tracer):
    """Device timing through completion probes.

    ``device_dispatch`` (emitted by ``tensor_filter`` right after the
    backend's invoke returns) hands the dispatch's CUDA event pair to a
    bounded probe queue; a background reaper thread waits on the second
    event and records a ``device_exec`` span (ts = enqueue, dur =
    enqueue→done, ``device_ms`` = the pair's elapsed time) on its own
    thread, a device track in the Perfetto export, linked to the host
    dispatch span by a flow arrow.  Histograms and counters land on the
    metrics registry; the queue bound and its overflow count keep a wedged
    card from backing memory up into the pipeline.
    """

    name = "device"

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity: Optional[int] = None):
        super().__init__(registry)
        self._capacity = capacity
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._reaper: Optional[threading.Thread] = None
        self._running = False
        self._lock = threading.Lock()
        self._by_element: Dict[str, List[int]] = {}  # name -> [count, ns, event ns]
        # label -> [count, ns, flops_sum, cost_missing_count, event ns]:
        # every dispatch counts (cost-less ones in the missing column, read
        # as mfu=None, never omitted)
        self._by_device: Dict[str, List] = {}
        # label -> (last completion ts_ns, probe queue empty then): the
        # dead-time tracker behind device_idle spans
        self._last_end: Dict[str, tuple] = {}
        self._usage = _util.DeviceUsage()
        self._sent = 0
        self._completed = 0
        self._dropped = 0
        self._compiles: Dict[str, int] = {"hit": 0, "miss": 0, "persist_hit": 0, "evict": 0}
        self._last_compile: Optional[dict] = None
        self._mem_handle = None
        self._busy_handle = None
        self._busy_decay_handle = None

    def _install(self) -> None:
        global _event_timing
        cap = self._capacity if self._capacity is not None else configured_probe_capacity()
        self._cap = max(1, int(cap))
        # the device lane records into the flight recorder even with no
        # SpanTracer attached: NNSTPU_TRACERS=device alone yields a chrome
        # trace with device_exec spans
        spans._activate(spans.configured_flight_records())
        self._hist = self._registry.histogram(
            "nnstpu_device_exec_seconds",
            "True device execution time per dispatch, enqueue to "
            "completion (seconds; one series per mesh device when the "
            "dispatch spans a sharded output)",
            labelnames=("pipeline", "element", "device"),
            buckets=DEVICE_EXEC_BUCKETS_S,
        )
        self._dispatches = self._registry.counter(
            "nnstpu_device_dispatches_total",
            "Dispatches handed to the device completion reaper",
            labelnames=("pipeline", "element"),
        )
        self._drop_counter = self._registry.counter(
            "nnstpu_device_probe_dropped_total",
            "Completion probes dropped on reaper-queue overflow",
            labelnames=("pipeline",),
        )
        self._mfu_gauge = self._registry.gauge(
            "nnstpu_mfu",
            "Model FLOPs utilization of the last observed dispatch "
            "(cost_analysis flops / device time / peak; see [obs] "
            "peak_tflops / NNSTPU_PEAK_TFLOPS)",
            labelnames=("device", "node", "bucket"),
        )
        self._bound_counter = self._registry.counter(
            "nnstpu_roofline_dispatches_total",
            "Observed dispatches by roofline classification (arithmetic "
            "intensity vs the peak_tflops/peak_gbs ridge point)",
            labelnames=("pipeline", "device", "bound"),
        )
        self._busy_gauge = self._registry.gauge(
            "nnstpu_device_busy_fraction",
            "Fraction of the trailing [obs] busy_window_s each device "
            "spent executing observed dispatches (device_exec coverage)",
            labelnames=("device",),
        )
        self._peak_tf = _util.peak_tflops()
        self._peak_gb = _util.peak_gbs()
        self._idle_gap_ns = int(_util.configured_idle_gap_ms() * 1e6)
        if self._busy_decay_handle is not None:
            # restarted while the previous stop()'s decay still runs: the
            # live collector takes over
            self._registry.remove_collector(self._busy_decay_handle)
            self._busy_decay_handle = None
        self._busy_handle = self._registry.add_collector(self._collect_busy)
        self._mem_handle = register_memory_gauges(self._registry)
        self._running = True
        self._reaper = threading.Thread(target=self._reap, name="device:cuda", daemon=True)
        self._reaper.start()
        with _timing_lock:
            _event_timing += 1
        self._connect("device_dispatch", self._on_device_dispatch)
        self._connect("compile", self._on_compile)

    def stop(self) -> None:
        global _event_timing
        was_active = bool(self._conns)
        super().stop()
        if not was_active:
            return
        with _timing_lock:
            _event_timing = max(0, _event_timing - 1)
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._reaper is not None:
            # a reaper blocked on a wedged card is abandoned (daemon); its
            # probes stay registered as in flight
            self._reaper.join(timeout=5)
            self._reaper = None
        if self._mem_handle is not None:
            self._registry.remove_collector(self._mem_handle)
            self._mem_handle = None
        if self._busy_handle is not None:
            self._registry.remove_collector(self._busy_handle)
            self._busy_handle = None
            self._install_busy_decay()
        spans._deactivate()

    def _install_busy_decay(self) -> None:
        """Replace the live busy collector with a self-removing decaying
        one: after stop() the gauge keeps tracking the shrinking windowed
        busy fraction and reads 0 once the window has passed with no reaps
        (a frozen last value would mislead an idle read between runs).  The
        series stays present."""
        gauge = self._busy_gauge
        window_ns = int(_util.configured_busy_window_s() * 1e9)
        deadline = now_ns() + window_ns
        usage = self._usage
        registry = self._registry

        def decay() -> None:
            done = now_ns() >= deadline
            fracs = {} if done else usage.busy_fractions()
            for device in usage.devices():
                gauge.set(round(fracs.get(device, 0.0), 6), device=device)
            if done:
                registry.remove_collector(decay)
                if self._busy_decay_handle is decay:
                    self._busy_decay_handle = None

        self._busy_decay_handle = registry.add_collector(decay)

    # -- hook callbacks ------------------------------------------------------

    def _on_device_dispatch(self, node, frame, outs, t0_ns) -> None:
        if node.pipeline is not self._pipeline:
            return
        ctx = spans.context_of(frame)
        trace_id, parent = (ctx[0], ctx[1]) if ctx is not None else (0, 0)
        head = outs[0] if isinstance(outs, (tuple, list)) and outs else outs
        events = getattr(node, "_device_events", None)
        # the capture's cost fingerprint, read on the dispatching thread so
        # that it matches the geometry just invoked
        cost_key = None
        ck_fn = getattr(getattr(node, "backend", None), "cost_key", None)
        if ck_fn is not None:
            cost_key = ck_fn()
        # a sharded dispatch's shards, read on the dispatching thread too
        shards = getattr(getattr(node, "backend", None), "last_shards", None)
        pid = next(spans._ids)
        fid = next(spans._flow_ids)
        # flow start on the dispatching (host) thread's row, inside the host
        # dispatch span: Perfetto draws the arrow host span -> device span
        # (under the lanes the row is the task's logical name)
        spans._recorder.append((
            spans.PH_FLOW_START, now_ns(), 0, spans._tid(),
            "device", "device", trace_id, fid, 0, None))
        with self._cv:
            if len(self._q) >= self._cap:
                self._dropped += 1
                self._drop_counter.inc(1, pipeline=self._pipeline.name)
                return
            self._sent += 1
            with _inflight_lock:
                _inflight[pid] = (t0_ns, node.name)
            self._q.append((pid, node.name, head, events, t0_ns, trace_id, parent, fid,
                            cost_key, shards))
            self._cv.notify()

    def _on_compile(self, backend, key, result, dur_ns, info) -> None:
        del backend, key, dur_ns
        with self._lock:
            self._compiles[result] = self._compiles.get(result, 0) + 1
            if result == "miss" and info:
                self._last_compile = dict(info)

    # -- the reaper ----------------------------------------------------------

    def _reap(self) -> None:
        pipeline_name = self._pipeline.name
        while True:
            with self._cv:
                while self._running and not self._q:
                    self._cv.wait(0.5)
                if not self._running and not self._q:
                    return
                (pid, name, head, events, t0, trace_id, parent, fid,
                 cost_key, shards) = self._q.popleft()
            try:
                if shards:
                    self._reap_sharded(shards, name, t0, trace_id, parent, fid,
                                       pipeline_name, cost_key)
                    continue
                dev_ns = None
                if events is not None:
                    begin, end = events
                    end.synchronize()
                    if begin is not None:
                        dev_ns = int(begin.elapsed_time(end) * 1e6)
                t_done = now_ns()
                dur = max(0, t_done - t0)
                label = _tensor_device_label(head)
                track = threading.current_thread().name
                sid = next(spans._ids)
                args = {"element": name, "device": label}
                if dev_ns is not None:
                    args["device_ms"] = dev_ns / 1e6
                args.update(self._utilization(label, track, name, t0, dur, dev_ns, trace_id,
                                              parent, cost_key, pipeline_name))
                # both records land on this thread: the device track
                spans._recorder.append((
                    spans.PH_FLOW_END, t0, 0, track, "device", "device",
                    trace_id, fid, 0, None))
                spans._recorder.append((
                    spans.PH_COMPLETE, t0, dur, track, "device_exec",
                    "device", trace_id, sid, parent, args))
                self._hist.observe(dur / 1e9, pipeline=pipeline_name, element=name,
                                   device=label)
                self._dispatches.inc(1, pipeline=pipeline_name, element=name)
                with self._lock:
                    self._completed += 1
                    c = self._by_element.setdefault(name, [0, 0, 0])
                    c[0] += 1
                    c[1] += dur
                    c[2] += dev_ns or 0
            except Exception:  # noqa: BLE001 - a poison probe must not kill the reaper
                import logging

                logging.getLogger("nnstreamer_tpu_torch.obs").exception(
                    "device completion probe failed for %s", name)
            finally:
                with _inflight_lock:
                    _inflight.pop(pid, None)
                # a device completion wakes the dispatcher lanes: idle lanes
                # and backpressured producers poll again now, not at the
                # next timeout tick
                try:
                    from ..graph import lanes as _lanes

                    _lanes.device_wakeup()
                except Exception:  # noqa: BLE001 - observability only
                    pass

    def _reap_sharded(self, shards, name, t0, trace_id, parent, fid, pipeline_name,
                      cost_key=None) -> None:
        """Per-shard completion of a sharded dispatch: each shard's last
        event waited on in turn (its segments' event pairs summed for its
        ``device_ms``), a ``device_exec`` span on the shard's own
        ``device:<label>`` track (the host span's flow arrow lands on the
        first), and a ``nnstpu_device_exec_seconds{device=...}``
        observation, so that skew between shards shows side by side."""
        nshards = max(1, len(shards))
        total = 0
        for k, (label, pairs) in enumerate(shards):
            dev_ns = None
            if pairs:
                pairs[-1][1].synchronize()
                dev_ns = int(sum(b.elapsed_time(e) for b, e in pairs) * 1e6)
            dur = max(0, now_ns() - t0)
            total = max(total, dur)
            track = f"device:{label}"
            if k == 0:
                spans._recorder.append((
                    spans.PH_FLOW_END, t0, 0, track, "device", "device",
                    trace_id, fid, 0, None))
            args = {"element": name, "device": label}
            if dev_ns is not None:
                args["device_ms"] = dev_ns / 1e6
            args.update(self._utilization(label, track, name, t0, dur, dev_ns, trace_id,
                                          parent, cost_key, pipeline_name, nshards=nshards))
            spans._recorder.append((
                spans.PH_COMPLETE, t0, dur, track, "device_exec", "device",
                trace_id, next(spans._ids), parent, args))
            self._hist.observe(dur / 1e9, pipeline=pipeline_name, element=name, device=label)
        self._dispatches.inc(1, pipeline=pipeline_name, element=name)
        with self._lock:
            self._completed += 1
            c = self._by_element.setdefault(name, [0, 0, 0])
            c[0] += 1
            c[1] += total

    # -- utilization attribution ---------------------------------------------

    def _utilization(self, label, track, name, t0, dur, dev_ns, trace_id, parent,
                     cost_key, pipeline_name, nshards: int = 1) -> dict:
        """Per-dispatch efficiency attribution: roofline args for the
        ``device_exec`` span (over the event pair's time where there is
        one, else over enqueue→done), the ``nnstpu_mfu`` gauge and roofline
        counter, the busy-interval feed, the ``device_idle`` gap span when
        the card sat starved since its last observed completion, and the
        by-device aggregates.  Cost-less dispatches count everywhere, with
        ``mfu: None``.  Never raises."""
        extra: dict = {}
        try:
            t_done = t0 + dur
            info = _util.cost_of(cost_key)
            flops = bytes_ = None
            bucket = 0
            if info is not None:
                bucket = int(info.get("bucket") or 0)
                flops = info.get("flops")
                bytes_ = info.get("bytes")
                if nshards > 1:  # the capture's cost covers every shard
                    flops = flops / nshards if flops else flops
                    bytes_ = bytes_ / nshards if bytes_ else bytes_
                extra["cost_key"] = cost_key
                if flops:
                    extra["flops"] = flops
                if bytes_:
                    extra["bytes"] = bytes_
            busy_ns = dev_ns if dev_ns else dur
            rl = _util.roofline(flops, bytes_, busy_ns / 1e9, self._peak_tf, self._peak_gb)
            sig = lambda v: float(f"{v:.4g}")  # noqa: E731 - 4 significant digits
            extra["mfu"] = sig(rl["mfu"]) if rl["mfu"] is not None else None
            extra["roofline"] = rl["bound"]
            if rl["achieved_tflops"] is not None:
                extra["achieved_tflops"] = sig(rl["achieved_tflops"])
            if rl["achieved_gbs"] is not None:
                extra["achieved_gbs"] = sig(rl["achieved_gbs"])
            if rl["intensity"] is not None:
                extra["intensity"] = sig(rl["intensity"])
            if rl["mfu"] is not None:
                self._mfu_gauge.set(rl["mfu"], device=label, node=name, bucket=str(bucket))
            self._bound_counter.inc(1, pipeline=pipeline_name, device=label, bound=rl["bound"])
            # dead time: a gap since this device's last observed completion
            # of at least [obs] device_idle_gap_ms becomes a device_idle span
            prev = self._last_end.get(label)
            if prev is not None and t0 - prev[0] >= self._idle_gap_ns:
                gap = t0 - prev[0]
                wire = _util.last_wire_health()
                if wire is not None and wire.get("regime") == "slow":
                    reason = "wire"
                elif prev[1]:
                    # nothing was enqueued when the card went idle: the host
                    # starved it
                    reason = "host_dispatch"
                else:
                    reason = "queue_wait"
                spans._recorder.append((
                    spans.PH_COMPLETE, prev[0], gap, track, "device_idle",
                    "device", trace_id, next(spans._ids), parent,
                    {"device": label, "gap_ms": round(gap / 1e6, 3), "reason": reason}))
            with self._cv:
                q_empty = not self._q
            self._last_end[label] = (t_done, q_empty)
            self._usage.add(label, t0, t_done)
            # the gauge is set here too (windowed up to this completion), so
            # the series stays present after stop() removed the collector
            frac = self._usage.busy_fractions(now_ns=t_done).get(label)
            if frac is not None:
                self._busy_gauge.set(round(frac, 6), device=label)
            with self._lock:
                d = self._by_device.setdefault(label, [0, 0, 0.0, 0, 0])
                d[0] += 1
                d[1] += dur
                d[4] += busy_ns
                if flops:
                    d[2] += flops
                else:
                    d[3] += 1
            if _hooks.enabled:
                # one emission per observed completion, with the duration the
                # device_exec span records
                info = {"bucket": bucket, "mesh": nshards}
                if cost_key:
                    info["cost_key"] = cost_key
                if flops:
                    info["flops"] = flops
                if bytes_:
                    info["bytes"] = bytes_
                if extra.get("mfu") is not None:
                    info["mfu"] = extra["mfu"]
                if dev_ns is not None:
                    info["device_ns"] = dev_ns
                _hooks.emit("device_exec", pipeline_name, name, label, t0, dur, info)
        except Exception:  # noqa: BLE001 - attribution must never kill a probe
            import logging

            logging.getLogger("nnstreamer_tpu_torch.obs").exception(
                "utilization attribution failed for %s", name)
        return extra

    def _collect_busy(self) -> None:
        """Scrape-time collector: windowed busy fraction per device."""
        for device, frac in self._usage.busy_fractions().items():
            self._busy_gauge.set(round(frac, 6), device=device)

    def summary(self) -> dict:
        with self._cv:
            inflight = len(self._q)
        busy = self._usage.busy_fractions()
        peak_tf = getattr(self, "_peak_tf", None) or _util.peak_tflops()
        with self._lock:
            per = {name: {"count": c[0], "device_ns": c[1], "event_ns": c[2]}
                   for name, c in self._by_element.items()}
            per_dev = {}
            for label, c in self._by_device.items():
                count, ns, flops_sum, missing, busy_ns = c
                # aggregate MFU over the device's event-pair time; None (not
                # omission) when no dispatch carried a cost
                mfu = None
                if flops_sum and busy_ns > 0:
                    mfu = float(f"{flops_sum / (busy_ns / 1e9) / (peak_tf * 1e12):.4g}")
                entry = {"count": count, "device_ns": ns, "event_ns": busy_ns, "mfu": mfu,
                         "cost_missing": missing}
                frac = busy.get(label)
                if frac is not None:
                    entry["busy_fraction"] = round(frac, 4)
                per_dev[label] = entry
            out = {
                "dispatches": self._sent,
                "completed": self._completed,
                "dropped": self._dropped,
                "inflight": inflight,
                "device_ns": sum(c[1] for c in self._by_element.values()),
                "by_element": per,
                "by_device": per_dev,
                "compiles": dict(self._compiles),
            }
            if self._last_compile:
                out["last_compile"] = dict(self._last_compile)
        return out


# self-registration (obs/__init__ imports this module, so
# NNSTPU_TRACERS=device and attach_tracer("device") resolve)
from .tracers import TRACERS  # noqa: E402

TRACERS[DeviceTracer.name] = DeviceTracer
