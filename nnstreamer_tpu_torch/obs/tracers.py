"""Pluggable tracers: the ``GST_TRACERS=latency;stats`` analog.

The port's copy of the JAX package's ``obs/tracers.py``, with the same
metric names.  No callback reads a tensor's values (a device tensor's read
would add a host synchronization, and a device operation, per frame): byte
counts come from shapes and element sizes.

A tracer attaches to one pipeline, connects callbacks to the hook bus
(:mod:`.hooks`), and folds what it sees into the metrics registry
(:mod:`.metrics`) plus an in-object summary readable via
``pipeline.stats()``:

- ``latency`` — per-frame **end-to-end** source→sink latency.  The source
  thread stamps each frame's ``meta`` at push (frame identity travels with
  the frame through every element, queue hop, and ``with_tensors`` copy —
  the GstMeta discipline); the sink-side dispatch-enter hook reads the
  stamp back.  One histogram per (pipeline, src, sink) pair.
- ``stats`` — per-element frame/byte throughput (counted at every src-pad
  push) and live frame-queue occupancy.
- ``drops`` — every way this runtime sheds load: queue leaky drops,
  ``tensor_rate`` drops/duplications, and dynbatch coalescing (batches
  emitted + padding rows); the port emits the queue's so far;
- ``copies`` — host copies on the hot path: on the port, the upload's
  pinned staging copy of every host frame it moves to the card.

Activation: ``NNSTPU_TRACERS=latency;stats`` (conf-driven, read at
pipeline start) or ``pipeline.attach_tracer("latency")``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

from ..utils.profiling import summarize_ns
from . import hooks
from .metrics import REGISTRY, MetricsRegistry


def _nbytes(t) -> int:
    """Payload byte size from the shape and the element size, never from
    the values: a torch tensor as ``numel() * element_size()``, anything
    else (a numpy array) by its ``nbytes``."""
    numel = getattr(t, "numel", None)
    if callable(numel):
        return int(numel()) * int(t.element_size())
    return int(t.nbytes)


class Tracer:
    """Base: connect/disconnect bookkeeping + the attach lifecycle."""

    name = "tracer"

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry if registry is not None else REGISTRY
        self._pipeline = None
        self._conns = []

    @property
    def active(self) -> bool:
        return bool(self._conns)

    def _connect(self, hook: str, fn) -> None:
        hooks.connect(hook, fn)
        self._conns.append((hook, fn))

    def start(self, pipeline) -> None:
        """Install hook callbacks for ``pipeline`` (idempotent)."""
        if self._conns:
            return
        self._pipeline = pipeline
        self._install()

    def stop(self) -> None:
        """Disconnect from the bus; accumulated data stays readable."""
        for hook, fn in self._conns:
            hooks.disconnect(hook, fn)
        self._conns.clear()

    def _install(self) -> None:
        raise NotImplementedError

    def summary(self) -> dict:
        return {}


class LatencyTracer(Tracer):
    """Per-frame src→sink latency, correlated by a meta stamp."""

    name = "latency"
    STAMP = "obs_latency"

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 keep: int = 8192):
        super().__init__(registry)
        self._keep = int(keep)
        self._lat: Dict[tuple, collections.deque] = {}
        self._lock = threading.Lock()
        self._leaves: set = set()

    def _install(self) -> None:
        self._leaves = set(self._pipeline._leaves)
        self._hist = self._registry.histogram(
            "nnstpu_e2e_latency_ms",
            "End-to-end per-frame source->sink latency (milliseconds)",
            labelnames=("pipeline", "src", "sink"),
        )
        self._connect("source_push", self._on_source_push)
        self._connect("dispatch_enter", self._on_dispatch_enter)

    def _on_source_push(self, pipeline, node, frame) -> None:
        if pipeline is self._pipeline:
            frame.meta[self.STAMP] = (node.name, time.perf_counter_ns())

    def _on_dispatch_enter(self, node, pad, item, t0) -> None:
        del pad
        meta = getattr(item, "meta", None)
        if meta is None:
            return
        stamp = meta.get(self.STAMP)
        if (stamp is None or node.pipeline is not self._pipeline
                or node.name not in self._leaves):
            return
        src, t_src = stamp
        dt_ns = t0 - t_src
        self._hist.observe(dt_ns / 1e6, pipeline=self._pipeline.name,
                           src=src, sink=node.name)
        with self._lock:
            dq = self._lat.get((src, node.name))
            if dq is None:
                dq = self._lat[(src, node.name)] = collections.deque(
                    maxlen=self._keep)
            dq.append(dt_ns)

    def summary(self) -> dict:
        """{'src->sink': {count, mean_ms, p50/p90/p99, min/max}} — exact
        percentiles over the retained window (last ``keep`` frames)."""
        with self._lock:
            snap = {k: list(v) for k, v in self._lat.items()}
        return {f"{src}->{sink}": summarize_ns(ns)
                for (src, sink), ns in snap.items() if ns}


class StatsTracer(Tracer):
    """Per-element frame/byte throughput + queue occupancy."""

    name = "stats"

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        super().__init__(registry)
        self._lock = threading.Lock()
        self._counts: Dict[str, list] = {}   # element -> [frames, bytes]
        self._depths: Dict[str, int] = {}    # element -> last depth
        self._pad_children: Dict[int, tuple] = {}

    def _install(self) -> None:
        self._frames = self._registry.counter(
            "nnstpu_element_frames_total",
            "Frames pushed out of each element src pad",
            labelnames=("pipeline", "element", "pad"),
        )
        self._bytes = self._registry.counter(
            "nnstpu_element_bytes_total",
            "Payload bytes pushed out of each element src pad",
            labelnames=("pipeline", "element", "pad"),
        )
        self._depth = self._registry.gauge(
            "nnstpu_queue_depth",
            "Frame-queue occupancy (buffers currently queued)",
            labelnames=("pipeline", "element"),
        )
        self._connect("pad_push", self._on_pad_push)
        self._connect("queue_push", self._on_queue_depth)
        self._connect("queue_pop", self._on_queue_depth)

    def _on_pad_push(self, pad, item) -> None:
        node = pad.node
        if node.pipeline is not self._pipeline:
            return
        tensors = getattr(item, "tensors", None)
        if tensors is None:
            return  # in-band events are not throughput
        children = self._pad_children.get(id(pad))
        if children is None:
            labels = dict(pipeline=self._pipeline.name, element=node.name,
                          pad=pad.name)
            children = (self._frames.labels(**labels),
                        self._bytes.labels(**labels))
            self._pad_children[id(pad)] = children
        nbytes = sum(_nbytes(t) for t in tensors)
        children[0].inc()
        children[1].inc(nbytes)
        with self._lock:
            c = self._counts.setdefault(node.name, [0, 0])
            c[0] += 1
            c[1] += nbytes

    def _on_queue_depth(self, node, depth) -> None:
        if node.pipeline is not self._pipeline:
            return
        self._depth.set(depth, pipeline=self._pipeline.name,
                        element=node.name)
        with self._lock:
            self._depths[node.name] = depth

    def summary(self) -> dict:
        with self._lock:
            out = {name: {"frames": c[0], "bytes": c[1]}
                   for name, c in self._counts.items()}
            for name, depth in self._depths.items():
                out.setdefault(name, {})["queue_depth"] = depth
        return out


class DropsTracer(Tracer):
    """Every shed frame: queue leaks, rate drops/dups, dynbatch padding."""

    name = "drops"

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        super().__init__(registry)
        self._lock = threading.Lock()
        self._by_element: Dict[str, Dict[str, int]] = {}

    def _install(self) -> None:
        self._drops = self._registry.counter(
            "nnstpu_drops_total",
            "Frames dropped, by element and reason",
            labelnames=("pipeline", "element", "reason"),
        )
        self._dups = self._registry.counter(
            "nnstpu_dups_total",
            "Frames duplicated/padded, by element and reason",
            labelnames=("pipeline", "element", "reason"),
        )
        self._flushes = self._registry.counter(
            "nnstpu_dynbatch_flushes_total",
            "Batches emitted by tensor_dynbatch",
            labelnames=("pipeline", "element"),
        )
        self._connect("queue_drop", self._on_queue_drop)
        self._connect("rate_drop", self._on_rate_drop)
        self._connect("rate_dup", self._on_rate_dup)
        self._connect("dynbatch_flush", self._on_dynbatch_flush)

    def _count(self, node, key: str, amount: int = 1) -> None:
        with self._lock:
            per = self._by_element.setdefault(node.name, {})
            per[key] = per.get(key, 0) + amount

    def _mine(self, node) -> bool:
        return node.pipeline is self._pipeline

    def _on_queue_drop(self, node, reason) -> None:
        if self._mine(node):
            self._drops.inc(1, pipeline=self._pipeline.name,
                            element=node.name, reason=f"queue_{reason}")
            self._count(node, f"queue_{reason}")

    def _on_rate_drop(self, node) -> None:
        if self._mine(node):
            self._drops.inc(1, pipeline=self._pipeline.name,
                            element=node.name, reason="rate")
            self._count(node, "rate_drop")

    def _on_rate_dup(self, node) -> None:
        if self._mine(node):
            self._dups.inc(1, pipeline=self._pipeline.name,
                           element=node.name, reason="rate")
            self._count(node, "rate_dup")

    def _on_dynbatch_flush(self, node, n, bucket) -> None:
        if not self._mine(node):
            return
        self._flushes.inc(1, pipeline=self._pipeline.name, element=node.name)
        self._count(node, "dynbatch_flushes")
        pad_rows = bucket - n
        if pad_rows > 0:
            self._dups.inc(pad_rows, pipeline=self._pipeline.name,
                           element=node.name, reason="dynbatch_pad")
            self._count(node, "dynbatch_pad_rows", pad_rows)

    def summary(self) -> dict:
        with self._lock:
            return {name: dict(per) for name, per in self._by_element.items()}


class CopiesTracer(Tracer):
    """Host memcpy + allocation accounting on the zero-copy hot path.

    Every ``copy`` hook emission (batch slot assembly, wire staging,
    forced WireTensor materialization) folds into per-element byte/copy/
    alloc counters; source pushes count frames so ``summary()`` can report
    **bytes copied per source frame** — the number the CI copy-regression
    gate and ``tools/profile_mux_overhead.py`` watch.  Copies emitted by
    backend objects (no ``pipeline`` attribute) are attributed by type
    name: they belong to whichever pipeline's filter invoked them, which a
    single-pipeline process (the bench/CI shape) makes unambiguous.
    """

    name = "copies"

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        super().__init__(registry)
        self._lock = threading.Lock()
        self._by_element: Dict[str, list] = {}  # name -> [bytes, copies, allocs]
        self._frames = 0

    def _install(self) -> None:
        self._bytes = self._registry.counter(
            "nnstpu_copy_bytes_total",
            "Host bytes memcpy'd on the frame hot path",
            labelnames=("pipeline", "element"),
        )
        self._copies = self._registry.counter(
            "nnstpu_copies_total",
            "Host memcpy operations on the frame hot path",
            labelnames=("pipeline", "element"),
        )
        self._allocs = self._registry.counter(
            "nnstpu_copy_allocs_total",
            "Fresh (unpooled) buffer allocations behind hot-path copies",
            labelnames=("pipeline", "element"),
        )
        self._connect("copy", self._on_copy)
        self._connect("source_push", self._on_source_push)

    def _on_copy(self, node, nbytes, allocs) -> None:
        pipeline = getattr(node, "pipeline", None)
        if pipeline is not None and pipeline is not self._pipeline:
            return
        name = getattr(node, "name", None) or type(node).__name__
        self._bytes.inc(nbytes, pipeline=self._pipeline.name, element=name)
        self._copies.inc(1, pipeline=self._pipeline.name, element=name)
        if allocs:
            self._allocs.inc(allocs, pipeline=self._pipeline.name,
                             element=name)
        with self._lock:
            c = self._by_element.setdefault(name, [0, 0, 0])
            c[0] += int(nbytes)
            c[1] += 1
            c[2] += int(allocs)

    def _on_source_push(self, pipeline, node, frame) -> None:
        del node, frame
        if pipeline is self._pipeline:
            with self._lock:
                self._frames += 1

    def summary(self) -> dict:
        with self._lock:
            per = {name: {"bytes": c[0], "copies": c[1], "allocs": c[2]}
                   for name, c in self._by_element.items()}
            frames = self._frames
        total = sum(c["bytes"] for c in per.values())
        allocs = sum(c["allocs"] for c in per.values())
        return {
            "elements": per,
            "frames": frames,
            "total_bytes": total,
            "total_allocs": allocs,
            "bytes_per_frame": total / frames if frames else 0.0,
        }


TRACERS = {
    LatencyTracer.name: LatencyTracer,
    StatsTracer.name: StatsTracer,
    DropsTracer.name: DropsTracer,
    CopiesTracer.name: CopiesTracer,
}


def make_tracer(name: str, **kwargs) -> Tracer:
    try:
        cls = TRACERS[name]
    except KeyError:
        raise ValueError(
            f"unknown tracer {name!r} (known: {', '.join(sorted(TRACERS))})"
        ) from None
    return cls(**kwargs)


def parse_tracer_names(value: str):
    """Split a ``GST_TRACERS``-style list: ``"latency;stats"`` (commas
    accepted too)."""
    return [t.strip() for t in (value or "").replace(",", ";").split(";")
            if t.strip()]
