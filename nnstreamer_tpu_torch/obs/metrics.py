"""Labeled metrics registry: counters, gauges, histograms.

The port's copy of the JAX package's ``obs/metrics.py``, with the same
metric names, exposition and quantile rules.  The storage layer under the
tracer subsystem (:mod:`.tracers`) and the Prometheus exposition
(:mod:`.export`).  Modeled on the prometheus_client data model —
``metric.labels(element="q0").inc()`` — but dependency-free and sized to
this runtime:

- metrics are get-or-create on the registry (idempotent across pipeline
  restarts; a kind or label-schema mismatch on re-register raises);
- label children are keyed by their value tuple, created on first touch;
- histograms use **fixed bucket boundaries** chosen at creation
  (:data:`LATENCY_BUCKETS_MS` spans 50 µs – 2.5 s, the useful range for
  per-frame pipeline latencies) so observation is a bisect + two adds;
- ``add_collector(fn)`` registers a callback run at collect/scrape time —
  how pull-style snapshots (serving-engine ``stats()``, queue depths)
  republish as gauges without a background poller.

All mutation is thread-safe (one lock per metric; the registry lock only
guards creation).
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# Default latency buckets (milliseconds): 50 µs to 2.5 s, roughly 1-2.5-5
# per decade — the GstShark/Prometheus-convention spacing.  Overridable
# per deployment via NNSTPU_METRICS_BUCKETS / ini [obs] buckets (see
# configured_latency_buckets) — a sub-ms edge pipeline and a multi-second
# batch server need different tails.
LATENCY_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0,
)


def parse_buckets(value: str) -> Optional[Tuple[float, ...]]:
    """``"0.1, 1; 10"`` → (0.1, 1.0, 10.0); empty/blank → None.

    Bounds are sorted AND deduplicated: a repeated bound would emit two
    identical cumulative ``le`` series, which Prometheus rejects."""
    vals = [x.strip() for x in (value or "").replace(";", ",").split(",")
            if x.strip()]
    if not vals:
        return None
    return tuple(sorted({float(x) for x in vals}))


def configured_latency_buckets() -> Tuple[float, ...]:
    """Histogram bucket bounds from the environment/conf, resolved at
    metric creation: ``NNSTPU_METRICS_BUCKETS`` (short spelling, a
    comma/semicolon-separated ms list) over ``NNSTPU_OBS_BUCKETS`` / ini
    ``[obs] buckets`` over :data:`LATENCY_BUCKETS_MS`.  A malformed list
    warns and falls back — observability never takes the process down."""
    import os

    val = os.environ.get("NNSTPU_METRICS_BUCKETS")
    if val is None:
        from ..conf import conf

        val = conf.get("obs", "buckets", "") or ""
    try:
        bounds = parse_buckets(val)
    except ValueError:
        import warnings

        warnings.warn(
            f"latency bucket override is not a number list: {val!r}; "
            "using the defaults", stacklevel=2)
        bounds = None
    return bounds if bounds else LATENCY_BUCKETS_MS

_INF = math.inf

# lazily bound obs.spans module — importing it at module top would cycle
# (spans → tracers → metrics); bound on the first observe() that runs
_spans = None


def _span_context() -> Optional[Tuple[int, int]]:
    """``(trace_id, span_id)`` of the live span on the calling thread, or
    None — the exemplar stamp.  Cheap when tracing is off: one module-
    global read plus an ``enabled`` check."""
    global _spans
    sp = _spans
    if sp is None:
        try:
            from . import spans as sp
        except ImportError:  # pragma: no cover — interpreter teardown
            return None
        _spans = sp
    if not sp.enabled:
        return None
    return sp.current()


def quantile_rank(sorted_values: Sequence, q: float):
    """Ceil-based nearest-rank quantile of a pre-sorted sample:
    ``s[max(0, ceil(q*n) - 1)]``, the smallest element ≥ ``q`` of the
    sample.  (A floor rank returns the MAX for every n ≤ 1/(1-q),
    biasing small-sample tails upward.)  Raises on an empty sample —
    callers own their empty default."""
    n = len(sorted_values)
    if n == 0:
        raise ValueError("quantile_rank of an empty sample")
    return sorted_values[max(0, math.ceil(q * n) - 1)]


def histogram_deltas(metric, prev: Dict[tuple, list],
                     label_filter: Optional[Dict[str, str]] = None,
                     ) -> List[Tuple[float, float]]:
    """Per-bucket growth of a registry histogram since the last call
    with the same ``prev`` dict — the *windowed* distribution a control
    loop or burn-rate evaluation must react to, not the lifetime one.

    ``prev`` maps child label tuple → that child's cumulative bucket
    counts at the previous call and is updated in place; pass a throwaway
    ``{}`` to read lifetime totals.  ``label_filter`` restricts to
    children whose labels include every given ``name: value``.  Returns
    sorted non-cumulative ``(le, grown)`` pairs, buckets that grew only
    (``le`` is +Inf for the overflow bucket)."""
    deltas: List[Tuple[float, float]] = []
    if metric is None:
        return deltas
    for key, child in metric.children():
        if label_filter:
            labels = dict(zip(metric.labelnames, key))
            if any(labels.get(k) != v for k, v in label_filter.items()):
                continue
        cumulative, _sum, _count = child.snapshot()
        base = prev.get(key)
        prev[key] = [acc for _b, acc in cumulative]
        last = 0.0
        for i, (bound, acc) in enumerate(cumulative):
            prior = base[i] if base and i < len(base) else 0.0
            grown = (acc - prior) - last
            last = acc - prior
            if grown > 0:
                deltas.append((bound, grown))
    deltas.sort()
    return deltas


def histogram_quantile(q: float, deltas: Sequence[Tuple[float, float]],
                       inf_value: float = _INF,
                       empty_value: float = 0.0) -> float:
    """Nearest-rank quantile over per-bucket ``(le, count)`` deltas (as
    produced by :func:`histogram_deltas`): the upper bound of the bucket
    holding the q-th observation.  The +Inf bucket reports as
    ``inf_value``; an empty window as ``empty_value``."""
    deltas = sorted(deltas)
    if not deltas:
        return float(empty_value)
    total = sum(n for _b, n in deltas)
    need = math.ceil(total * q)
    seen = 0.0
    for bound, n in deltas:
        seen += n
        if seen >= need:
            return float(inf_value) if bound == _INF else float(bound)
    return float(deltas[-1][0])


def _check_labels(labelnames: Tuple[str, ...], kv: Dict[str, str]) -> Tuple[str, ...]:
    if tuple(sorted(kv)) != tuple(sorted(labelnames)):
        raise ValueError(
            f"labels {sorted(kv)} do not match declared {sorted(labelnames)}"
        )
    return tuple(str(kv[name]) for name in labelnames)


class _Metric:
    """Shared child management for all metric kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        key = _check_labels(self.labelnames, kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _default(self):
        """The no-label child (metrics declared without labelnames)."""
        if self.labelnames:
            raise ValueError(f"{self.name}: labels required {self.labelnames}")
        with self._lock:
            child = self._children.get(())
            if child is None:
                child = self._make_child()
                self._children[()] = child
            return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class _Value:
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    @property
    def value(self) -> float:
        return self._v


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._v += amount


class _GaugeChild(_Value):
    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v -= amount


class _HistogramChild:
    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_lock",
                 "_exemplars")

    def __init__(self, bounds: Tuple[float, ...]):
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        # per-bucket last exemplar — (trace_id, value, unix ts) — stamped
        # from the active span context so a scraped tail bucket links
        # straight to its Perfetto trace; None until a traced observe hits
        self._exemplars: List[Optional[Tuple[int, float, float]]] = \
            [None] * (len(bounds) + 1)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self._bounds, value)
        ctx = _span_context()
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if ctx is not None:
                self._exemplars[i] = (ctx[0], value, time.time())

    def exemplars(self) -> List[Optional[Tuple[int, float, float]]]:
        """Per-bucket last exemplar, index-aligned with ``snapshot()``'s
        cumulative pairs (the final slot is the +Inf bucket)."""
        with self._lock:
            return list(self._exemplars)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> Tuple[List[Tuple[float, int]], float, int]:
        """(cumulative (le, count) pairs incl. +Inf, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        out, acc = [], 0
        for bound, c in zip(self._bounds + (_INF,), counts):
            acc += c
            out.append((bound, acc))
        return out, s, total


class Counter(_Metric):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0, **kv) -> None:
        (self.labels(**kv) if kv else self._default()).inc(amount)


class Gauge(_Metric):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float, **kv) -> None:
        (self.labels(**kv) if kv else self._default()).set(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=None):
        super().__init__(name, help, labelnames)
        if buckets is None:  # conf-driven default, resolved at creation
            buckets = configured_latency_buckets()
        bounds = tuple(sorted({float(b) for b in buckets}))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bounds

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float, **kv) -> None:
        (self.labels(**kv) if kv else self._default()).observe(value)


class MetricsRegistry:
    """Named metrics + scrape-time collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], None]] = []

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kwargs)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} "
                f"with labels {m.labelnames}"
            )
        buckets = kwargs.get("buckets")
        if buckets is not None:
            # silent bucket-schema drift corrupts every series already
            # recorded; an explicit re-register with different bounds is
            # the same contract violation as a label mismatch
            bounds = tuple(sorted({float(b) for b in buckets}))
            if bounds != m.buckets:
                raise ValueError(
                    f"metric {name!r} already registered with buckets "
                    f"{m.buckets}, re-registered with {bounds}"
                )
        return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def add_collector(self, fn: Callable[[], None]) -> Callable[[], None]:
        """Register a scrape-time callback (sets gauges from live state);
        returns ``fn`` as the removal handle."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)
        return fn

    def remove_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def collect(self) -> List[_Metric]:
        """Run collectors, then return metrics sorted by name."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a bad collector must not 500 the scrape
                import logging

                logging.getLogger("nnstreamer_tpu_torch.obs").exception(
                    "metrics collector %r failed", fn)
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self) -> None:
        """Drop every metric and collector (test isolation)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


# Process-default registry: tracers and the scrape endpoint share it, the
# same way utils.profiling keeps one process-global record table.
REGISTRY = MetricsRegistry()
