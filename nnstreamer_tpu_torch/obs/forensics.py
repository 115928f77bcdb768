"""Tail forensics: automatic root-cause verdicts for latency outliers.

Every layer below this one *measures* — spans decompose a frame's path
into legs (:func:`~nnstreamer_tpu_torch.obs.collector.attribute_trace`), the
cost observatory (:mod:`.costmodel`) banks per-stage leg baselines in
``COST_MODEL.json``, and perfdiff owns the noise band that separates a
real shift from jitter (:func:`~nnstreamer_tpu_torch.obs.costmodel.
leg_band_us`).  What was missing is the *closing of the loop* on the
p99.9 tail: when one frame in ten thousand blows the SLO an operator had
to fish the flight recorder by hand and eyeball the decomposition
against the cost model.  This module does that automatically:

- :class:`ForensicsEngine` scores each completed trace's total latency
  against a live Welford baseline (warmed over ``[obs]
  forensics_min_samples`` traces); a total outside the noise band is an
  **outlier**, and its leg decomposition is scored leg-by-leg against
  the pooled ``COST_MODEL.json`` baselines (plus whatever the engine has
  learned live) to produce a typed **verdict** naming the inflated leg:
  ``queue_wait`` | ``device`` | ``wire`` | ``host_dispatch`` |
  ``unattributed``.  Outliers are *excluded* from the baselines — the
  engine must not learn that slow is normal;
- every verdict increments ``nnstpu_tail_outliers_total{pipeline,leg}``;
- when ``[obs] forensics_dir`` is set, each outlier's per-trace flight
  dump (a ready-to-open Perfetto document) is captured to a bounded
  on-disk gallery — slowest-K retained (``forensics_keep``), total bytes
  capped (``forensics_max_bytes``) — with the verdict document alongside,
  so the trace behind a scraped exemplar is one ``cat`` away;
- :class:`ForensicsTracer` (``NNSTPU_TRACERS=forensics`` /
  ``pipeline.attach_tracer("forensics")``) runs the engine live on a
  pipeline: the LatencyTracer stamp pattern measures src→sink totals,
  and only frames that fail the cheap total gate pay for a flight-
  recorder slice + leg attribution;
- fleet/loadgen paths with no local pipeline score via
  :meth:`ForensicsEngine.score_trace` directly over the cluster
  collector's joined records (see ``tools/loadgen.py``).

Leg mapping from :data:`~nnstreamer_tpu_torch.obs.collector.SPAN_LEGS`
attribution (ns) to verdict legs (µs): ``queue``→``queue_wait``,
``device``→``device``, ``wire`` + per-edge ``hop:*``→``wire``,
``dispatch`` + ``route_overhead``→``host_dispatch``; the residual the
join could not cover stays ``unattributed``.  A leg with no baseline yet
scores its full magnitude — the bootstrap behavior that still names the
dominant leg before COST_MODEL.json exists.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .collector import attribute_trace
from .costmodel import (
    BAND_MIN_ABS_US,
    BAND_MIN_REL,
    BAND_SIGMAS,
    LegStat,
    combine_legs,
    leg_band_us,
    load_cost_model,
)
from .metrics import REGISTRY, MetricsRegistry
from .tracers import Tracer
from . import spans as _spans

# the typed verdict vocabulary, ordered for stable reporting
VERDICT_LEGS = ("queue_wait", "device", "wire", "host_dispatch")
UNATTRIBUTED = "unattributed"

# COST_MODEL.json leg name -> verdict leg
COST_LEG_TO_VERDICT = {
    "queue_wait": "queue_wait",
    "device_exec": "device",
    "wire": "wire",
    "dispatch": "host_dispatch",
}


def verdict_legs_us(legs_ns: Dict[str, float]) -> Dict[str, float]:
    """Fold an :func:`attribute_trace` decomposition (ns) into the
    verdict-leg vocabulary (µs)."""
    out: Dict[str, float] = {}

    def add(leg: str, ns: float) -> None:
        if ns:
            out[leg] = out.get(leg, 0.0) + ns / 1e3

    add("queue_wait", legs_ns.get("queue", 0.0))
    add("device", legs_ns.get("device", 0.0))
    add("wire", legs_ns.get("wire", 0.0))
    for key, ns in legs_ns.items():
        if key.startswith("hop:"):
            add("wire", ns)
    add("host_dispatch", legs_ns.get("dispatch", 0.0))
    add("host_dispatch", legs_ns.get("route_overhead", 0.0))
    add(UNATTRIBUTED, legs_ns.get("unattributed", 0.0))
    return out


def baselines_from_cost_model(doc: dict,
                              pipeline: str = "") -> Dict[str, dict]:
    """Pool a COST_MODEL.json document's per-stage leg aggregates into
    one Welford aggregate per verdict leg.  ``pipeline`` restricts to
    that pipeline's stages when any match (a model banked by a different
    deployment still seeds the whole-fleet shape otherwise)."""
    stages = (doc or {}).get("stages") or {}
    picked = [e for e in stages.values() if e.get("pipeline") == pipeline] \
        if pipeline else []
    if not picked:
        picked = list(stages.values())
    pooled: Dict[str, dict] = {}
    for entry in picked:
        for leg, stat in (entry.get("legs") or {}).items():
            verdict = COST_LEG_TO_VERDICT.get(leg)
            if verdict is not None and isinstance(stat, dict):
                pooled[verdict] = combine_legs(pooled.get(verdict, {}), stat)
    return pooled


def _conf_float(key: str, default: float) -> float:
    from ..conf import conf

    try:
        return conf.get_float("obs", key, default)
    except ValueError:
        return default


def _conf_int(key: str, default: int) -> int:
    return int(_conf_float(key, float(default)))


def configured_dir() -> str:
    """``[obs] forensics_dir`` ("" = score + count, never capture)."""
    from ..conf import conf

    return conf.get("obs", "forensics_dir", "") or ""


class _Gallery:
    """Bounded on-disk capture gallery: slowest-K retained, byte-capped.

    Entries are ``<pipeline>.<trace_id hex>.forensic.json`` files; the
    directory is rescanned at init so a restarted process keeps honoring
    the bound across its predecessor's captures."""

    SUFFIX = ".forensic.json"

    def __init__(self, dirpath: str, keep: int, max_bytes: int):
        self.dir = dirpath
        self.keep = max(1, int(keep))
        self.max_bytes = max(0, int(max_bytes))
        self.evicted = 0
        self._lock = threading.Lock()
        self._entries: List[Tuple[float, str, int]] = []  # (total_ms, path, bytes)
        os.makedirs(dirpath, exist_ok=True)
        for fname in sorted(os.listdir(dirpath)):
            if not fname.endswith(self.SUFFIX):
                continue
            path = os.path.join(dirpath, fname)
            try:
                with open(path) as f:
                    total = float(json.load(f).get("total_ms") or 0.0)
                self._entries.append((total, path, os.path.getsize(path)))
            except Exception:  # noqa: BLE001 — a corrupt capture is not load-bearing
                continue

    def add(self, doc: dict, flight: dict) -> Optional[str]:
        """Write one capture; evict smallest-total entries until the
        bounds hold again.  Returns the path, or None when the new
        capture itself was the smallest and fell straight out."""
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in (doc.get("pipeline") or "trace"))
        path = os.path.join(
            self.dir, f"{safe}.{doc.get('trace_id', '0')}{self.SUFFIX}")
        body = dict(doc)
        body["kind"] = "forensic_capture"
        body["flight"] = flight
        data = json.dumps(body, indent=1, sort_keys=True,
                          default=str).encode("utf-8")
        with self._lock:
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            except OSError:
                return None
            # replace a prior capture of the same trace in place
            self._entries = [e for e in self._entries if e[1] != path]
            self._entries.append(
                (float(doc.get("total_ms") or 0.0), path, len(data)))
            kept = path
            while len(self._entries) > self.keep or (
                    self.max_bytes and
                    sum(e[2] for e in self._entries) > self.max_bytes
                    and len(self._entries) > 1):
                victim = min(self._entries)
                self._entries.remove(victim)
                self.evicted += 1
                try:
                    os.remove(victim[1])
                except OSError:
                    pass
                if victim[1] == path:
                    kept = None
            return kept

    def summary(self) -> dict:
        with self._lock:
            return {
                "dir": self.dir,
                "entries": len(self._entries),
                "bytes": sum(e[2] for e in self._entries),
                "evicted": self.evicted,
                "slowest_ms": round(max((e[0] for e in self._entries),
                                        default=0.0), 3),
            }


class ForensicsEngine:
    """Score completed traces against cost-model baselines; emit typed
    outlier verdicts and capture a bounded flight-dump gallery.

    Every conf-shaped parameter defaults from ``[obs] forensics_*``;
    pass explicit values to pin behavior (tests, loadgen reports).
    ``cost_model`` may be a loaded document, a path, or None (the
    configured ``COST_MODEL.json``)."""

    def __init__(self, pipeline: str = "",
                 registry: Optional[MetricsRegistry] = None,
                 cost_model=None,
                 gallery_dir: Optional[str] = None,
                 keep: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 sigmas: Optional[float] = None,
                 min_rel: Optional[float] = None,
                 min_abs_us: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 alpha: float = 0.2):
        self.pipeline = pipeline
        registry = registry if registry is not None else REGISTRY
        self.sigmas = sigmas if sigmas is not None \
            else _conf_float("forensics_sigmas", BAND_SIGMAS)
        self.min_rel = min_rel if min_rel is not None \
            else _conf_float("forensics_min_rel", BAND_MIN_REL)
        self.min_abs_us = min_abs_us if min_abs_us is not None \
            else _conf_float("forensics_min_abs_us", BAND_MIN_ABS_US)
        self.min_samples = min_samples if min_samples is not None \
            else _conf_int("forensics_min_samples", 32)
        self._alpha = alpha
        if cost_model is None or isinstance(cost_model, str):
            cost_model = load_cost_model(cost_model)
        self._seed = baselines_from_cost_model(cost_model, pipeline)
        self._total = LegStat()
        self._legs: Dict[str, LegStat] = {leg: LegStat()
                                          for leg in VERDICT_LEGS}
        self._scored = 0
        self._verdicts: Dict[str, int] = {}
        self._lock = threading.Lock()
        gallery_dir = gallery_dir if gallery_dir is not None \
            else configured_dir()
        self.gallery = _Gallery(
            gallery_dir,
            keep if keep is not None else _conf_int("forensics_keep", 8),
            max_bytes if max_bytes is not None
            else _conf_int("forensics_max_bytes", 16 * 1024 * 1024),
        ) if gallery_dir else None
        self._outliers = registry.counter(
            "nnstpu_tail_outliers_total",
            "Latency outliers by root-cause verdict leg",
            labelnames=("pipeline", "leg"),
        )
        self._captures = registry.counter(
            "nnstpu_tail_captures_total",
            "Outlier flight dumps captured to the forensics gallery",
            labelnames=("pipeline",),
        )

    # -- baselines -----------------------------------------------------------

    def _leg_baseline(self, leg: str) -> dict:
        """Seed (COST_MODEL.json pooled) + live Welford, pooled exactly."""
        return combine_legs(self._seed.get(leg, {}),
                            self._legs[leg].snapshot())

    def _band(self, stat: dict) -> float:
        return leg_band_us(stat, self.sigmas, self.min_rel, self.min_abs_us)

    def baseline_snapshot(self) -> dict:
        with self._lock:
            total = self._total.snapshot()
            legs = {leg: self._leg_baseline(leg) for leg in VERDICT_LEGS}
        return {"total": total, "legs": legs}

    # -- scoring -------------------------------------------------------------

    def score_trace(self, trace_id: int, total_ns: float,
                    records: Optional[List[tuple]] = None,
                    fetch: Optional[Callable[[], List[tuple]]] = None,
                    ) -> Optional[dict]:
        """Score one completed trace; returns the verdict document for
        an outlier, else None.

        ``records`` are the trace's complete-span records (flight layout,
        extra trailing fields tolerated); ``fetch`` is the lazy variant —
        only called once the cheap total gate has flagged an outlier, so
        the per-frame hot path never pays for a ring snapshot."""
        total_us = float(total_ns) / 1e3
        with self._lock:
            self._scored += 1
            warming = self._total.count < self.min_samples
            if not warming:
                snap = self._total.snapshot()
                outlier = total_us > snap["mean_us"] + self._band(snap)
            else:
                snap = None
                outlier = False
            if not outlier:
                # inliers (and the warmup stream) feed the baselines;
                # outliers are excluded so slow never becomes normal
                self._total.add(total_us, self._alpha)
                if records is not None:
                    for leg, us in verdict_legs_us(
                            attribute_trace(records)).items():
                        if leg in self._legs:
                            self._legs[leg].add(us, self._alpha)
                return None
        if records is None:
            records = fetch() if fetch is not None else []
        legs_us = verdict_legs_us(attribute_trace(records)) if records else {}
        with self._lock:
            scored: Dict[str, float] = {}
            baseline: Dict[str, dict] = {}
            for leg in VERDICT_LEGS:
                us = legs_us.get(leg, 0.0)
                stat = self._leg_baseline(leg)
                if stat.get("count"):
                    band = self._band(stat)
                    excess = us - (float(stat.get("mean_us") or 0.0) + band)
                    baseline[leg] = {
                        "mean_ms": round(float(stat["mean_us"]) / 1e3, 4),
                        "band_ms": round(band / 1e3, 4),
                        "count": stat["count"],
                    }
                else:
                    # no baseline yet: the leg's whole magnitude is
                    # unexplained (bootstrap still names the dominant leg)
                    excess = us
                if excess > 0:
                    scored[leg] = excess
            residual = legs_us.get(UNATTRIBUTED, 0.0)
            if residual > 0:
                scored[UNATTRIBUTED] = residual
            verdict = max(scored, key=scored.get) if scored else UNATTRIBUTED
            self._verdicts[verdict] = self._verdicts.get(verdict, 0) + 1
            doc = {
                "pipeline": self.pipeline,
                "trace_id": f"{int(trace_id):x}",
                "verdict": verdict,
                "total_ms": round(total_us / 1e3, 4),
                "baseline_total_ms": {
                    "mean_ms": round(snap["mean_us"] / 1e3, 4),
                    "band_ms": round(self._band(snap) / 1e3, 4),
                    "count": snap["count"],
                },
                "legs_ms": {leg: round(us / 1e3, 4)
                            for leg, us in sorted(legs_us.items())},
                "excess_ms": {leg: round(us / 1e3, 4)
                              for leg, us in sorted(scored.items())},
                "baseline_legs": baseline,
                "captured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
            }
        self._outliers.inc(pipeline=self.pipeline, leg=verdict)
        if self.gallery is not None:
            flight = _spans.chrome_trace(
                [tuple(r[:10]) for r in records],
                process_name=self.pipeline or "forensics",
            ) if records else {"traceEvents": []}
            path = self.gallery.add(doc, flight)
            if path:
                doc["capture"] = path
                self._captures.inc(pipeline=self.pipeline)
        return doc

    def summary(self) -> dict:
        with self._lock:
            out = {
                "pipeline": self.pipeline,
                "scored": self._scored,
                "warming": self._total.count < self.min_samples,
                "outliers": dict(sorted(self._verdicts.items())),
                "baseline": {
                    "total": self._total.snapshot(),
                    "legs": {leg: self._leg_baseline(leg)
                             for leg in VERDICT_LEGS},
                },
            }
        if self.gallery is not None:
            out["gallery"] = self.gallery.summary()
        return out


class ForensicsTracer(Tracer):
    """Live outlier forensics on one pipeline's hook-bus feed.

    The LatencyTracer stamp pattern measures each frame's src→sink
    total; only totals that fail :class:`ForensicsEngine`'s cheap gate
    pay for a per-trace flight slice + leg attribution.  Verdict quality
    follows what else is attached: with ``spans`` (and ``device``)
    tracing active the decomposition is real; without it, outliers are
    still counted and captured with an ``unattributed`` verdict."""

    name = "forensics"
    STAMP = "obs_forensics"

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 engine: Optional[ForensicsEngine] = None, **engine_kwargs):
        super().__init__(registry)
        self._engine = engine
        self._engine_kwargs = engine_kwargs
        self._leaves: set = set()

    def _install(self) -> None:
        self._leaves = set(self._pipeline._leaves)
        if self._engine is None:
            self._engine = ForensicsEngine(
                pipeline=self._pipeline.name, registry=self._registry,
                **self._engine_kwargs)
        self._connect("source_push", self._on_source_push)
        self._connect("dispatch_enter", self._on_dispatch_enter)

    @property
    def engine(self) -> Optional[ForensicsEngine]:
        return self._engine

    def _on_source_push(self, pipeline, node, frame) -> None:
        del node
        if pipeline is self._pipeline:
            frame.meta[self.STAMP] = time.perf_counter_ns()

    def _on_dispatch_enter(self, node, pad, item, t0) -> None:
        del pad
        meta = getattr(item, "meta", None)
        if meta is None:
            return
        t_src = meta.get(self.STAMP)
        if (t_src is None or node.pipeline is not self._pipeline
                or node.name not in self._leaves):
            return
        ctx = meta.get(_spans.META_KEY)
        trace_id = ctx[0] if ctx else 0
        fetch = None
        if trace_id and _spans.enabled:
            fetch = lambda: _spans.records_for_trace(trace_id)  # noqa: E731
        self._engine.score_trace(trace_id, t0 - t_src, fetch=fetch)

    def summary(self) -> dict:
        return self._engine.summary() if self._engine is not None else {}


# self-registration (obs/__init__ imports this module, so
# NNSTPU_TRACERS=forensics / attach_tracer("forensics") resolve)
from .tracers import TRACERS  # noqa: E402

TRACERS[ForensicsTracer.name] = ForensicsTracer
