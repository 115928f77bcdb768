"""Cost observatory: the persistent per-stage cost model.

The port of the JAX package's ``obs/costmodel.py``, with the same
``COST_MODEL.json`` schema and version: each package reads and merges the
other's file.  In the port the ``device_exec`` leg is the CUDA-event device
lane's dispatch time (``obs/device.py``), and a stage's flops and bytes are
the cost registry's (``obs/util.py``, counted by ``FlopCounterMode`` at
capture).

An auto-partitioner needs a **measured** answer to "what
does each stage cost, and is it compute or transfer" — TVM's measure→
search→cache→serve loop (PAPERS.md 1802.04799) closed as an always-on
observability plane.  This module is the measure+cache half:

- :class:`CostModelTracer` (``NNSTPU_TRACERS=costmodel``) sits on the
  hook bus and aggregates, per (pipeline, node, bucket, mesh), the legs
  the spans+util lanes already emit:

  - ``dispatch`` — host-side per-node wall time (``dispatch_exit``,
    the same durations the nested dispatch spans record);
  - ``device_exec`` — TRUE device time from the device-lane reaper's
    ``device_exec`` hook (the same durations its Perfetto spans carry,
    so the model reconciles with the trace by construction), plus the
    executable's flops/bytes cost profile when registered;
  - ``queue_wait`` — per-item residency inside each frame queue,
    measured FIFO from the ``queue_push``/``queue_pop`` hooks
    (leaky drops are reconciled via ``queue_drop`` so the stamp FIFO
    never drifts), attributed to the queue element;
  - ``wire`` — host→device transfer cost estimated from the ``copy``
    hook's staged bytes priced at the live wire-health probe's put rate
    (:func:`~.util.last_wire_health`); bytes are counted even when no
    probe has published yet.

  Each leg keeps an exact aggregate (count/mean/M2 — Welford, so
  perfdiff gets a sample variance) plus a windowed EWMA (``[obs]
  costmodel_alpha``) exported as ``nnstpu_stage_cost_us{pipeline,node,
  leg}`` gauges and a ``cost_model`` provider in ``/stats.json``.

- :func:`merge_cost_model` persists the model to ``COST_MODEL.json``
  (``[obs] costmodel_path``), schema-versioned and idempotently merged
  like ``bench.merge_ladder_bank``: each stage entry banks a bounded
  per-run history (re-merging the same run's snapshot *replaces* that
  run's contribution — a flush is safe to repeat) and re-pools the
  cross-run aggregate the partitioner prices candidate cuts against
  offline.  Writes are atomic (tmp + ``os.replace``) and serialized
  in-process, so two pipelines flushing into one file interleave
  safely; cross-process races degrade to last-writer-wins on a valid
  document, never corruption.

``tools/perfdiff.py`` turns two of these models (fresh vs banked) into
typed ``improved``/``flat``/``regressed{leg}`` verdicts — see
``docs/observability.md`` "Cost observatory".
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Dict, Optional

from . import hooks
from . import util as _util
from .metrics import MetricsRegistry
from .tracers import Tracer

now_ns = time.perf_counter_ns

SCHEMA_VERSION = 1
DEFAULT_ALPHA = 0.2
MAX_RUNS = 4          # per-stage run history kept in COST_MODEL.json
LEGS = ("dispatch", "device_exec", "queue_wait", "wire")
_PROBE_NBYTES = 150_528  # the wire-health probe's put payload size

_persist_lock = threading.Lock()


# -- conf ---------------------------------------------------------------------

def cost_model_path() -> str:
    """Where the model persists: ini ``[obs] costmodel_path`` (env
    ``NNSTPU_OBS_COSTMODEL_PATH``), resolved against the cwd."""
    from ..conf import conf

    return conf.get("obs", "costmodel_path", "COST_MODEL.json") \
        or "COST_MODEL.json"


def configured_alpha() -> float:
    """EWMA smoothing factor for the stage-cost gauges: ini ``[obs]
    costmodel_alpha`` in (0, 1]."""
    from ..conf import conf

    try:
        a = conf.get_float("obs", "costmodel_alpha", DEFAULT_ALPHA)
    except ValueError:
        return DEFAULT_ALPHA
    return a if 0.0 < a <= 1.0 else DEFAULT_ALPHA


def configured_autosave() -> bool:
    """Whether tracer ``stop()`` flushes the model to disk: ini ``[obs]
    costmodel_autosave``."""
    from ..conf import conf

    return conf.get_bool("obs", "costmodel_autosave", True)


# -- leg statistics -----------------------------------------------------------

class LegStat:
    """One leg's accumulator: exact mean/M2 (Welford) + EWMA, µs."""

    __slots__ = ("count", "mean_us", "m2", "ewma_us", "last_us")

    def __init__(self):
        self.count = 0
        self.mean_us = 0.0
        self.m2 = 0.0
        self.ewma_us = 0.0
        self.last_us = 0.0

    def add(self, us: float, alpha: float) -> None:
        self.count += 1
        delta = us - self.mean_us
        self.mean_us += delta / self.count
        self.m2 += delta * (us - self.mean_us)
        self.ewma_us = us if self.count == 1 else (
            alpha * us + (1.0 - alpha) * self.ewma_us)
        self.last_us = us

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean_us": round(self.mean_us, 3),
            "ewma_us": round(self.ewma_us, 3),
            "m2": round(self.m2, 3),
        }


def leg_std_us(leg: dict) -> Optional[float]:
    """Sample standard deviation (µs) out of a persisted leg aggregate,
    or None below 2 samples — the noise-band input for perfdiff."""
    n = int(leg.get("count") or 0)
    if n < 2:
        return None
    m2 = float(leg.get("m2") or 0.0)
    if m2 < 0:
        return None
    return math.sqrt(m2 / (n - 1))


# noise-band floors shared by every consumer of leg aggregates
# (tools/perfdiff regression verdicts, obs/forensics outlier scoring)
BAND_SIGMAS = 3.0
BAND_MIN_REL = 0.10    # 10% floor: sub-noise-floor deltas stay flat
BAND_MIN_ABS_US = 5.0  # µs floor: scheduler jitter on tiny legs


def leg_band_us(leg_stat: dict, sigmas: float = BAND_SIGMAS,
                min_rel: float = BAND_MIN_REL,
                min_abs_us: float = BAND_MIN_ABS_US) -> float:
    """Noise band (µs) around one persisted leg aggregate's mean:
    ``max(min_rel × |mean|, min_abs_us, sigmas × sample-std)`` — a leg
    that historically swings 40% does not page anyone over a 10%
    delta.  Below 2 samples only the relative/absolute floors apply."""
    mean = float(leg_stat.get("mean_us") or 0.0)
    band = max(min_rel * abs(mean), min_abs_us)
    std = leg_std_us(leg_stat)
    if std is not None:
        band = max(band, sigmas * std)
    return band


def combine_legs(a: dict, b: dict) -> dict:
    """Pool two Welford aggregates ({count, mean_us, m2}) — the
    parallel-variance identity, exact regardless of merge order."""
    na, nb = int(a.get("count") or 0), int(b.get("count") or 0)
    if not na:
        return {k: b.get(k) for k in ("count", "mean_us", "m2")}
    if not nb:
        return {k: a.get(k) for k in ("count", "mean_us", "m2")}
    ma, mb = float(a.get("mean_us") or 0.0), float(b.get("mean_us") or 0.0)
    n = na + nb
    delta = mb - ma
    mean = ma + delta * nb / n
    m2 = (float(a.get("m2") or 0.0) + float(b.get("m2") or 0.0)
          + delta * delta * na * nb / n)
    return {"count": n, "mean_us": round(mean, 3), "m2": round(m2, 3)}


# -- persistence --------------------------------------------------------------

def load_cost_model(path: Optional[str] = None) -> dict:
    """The persisted model ({"schema": 1, "stages": {...}}), or an empty
    shell when the file is absent/unreadable/foreign-schema."""
    path = path or cost_model_path()
    try:
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and doc.get("schema") == SCHEMA_VERSION \
                and isinstance(doc.get("stages"), dict):
            return doc
    except Exception:  # noqa: BLE001 — a missing/corrupt file is a fresh start
        pass
    return {"schema": SCHEMA_VERSION, "stages": {}}


def _pool_runs(entry: dict) -> None:
    """Recompute ``entry['legs']`` by pooling the banked run history —
    called after every run insert/replace so the top-level aggregate is
    always consistent with the runs it summarizes."""
    pooled: Dict[str, dict] = {}
    for run in entry.get("runs", {}).values():
        for leg, stat in (run.get("legs") or {}).items():
            pooled[leg] = combine_legs(pooled.get(leg, {}), stat)
    entry["legs"] = pooled


def merge_cost_model(stages: Dict[str, dict], run_id: str,
                     path: Optional[str] = None) -> dict:
    """Idempotently merge one run's stage snapshots into the persisted
    model; returns the merged document.

    ``stages`` maps stage key (``pipeline|node|b<bucket>|mesh<mesh>``)
    to a snapshot carrying ``legs`` plus geometry/cost attributes.  Per
    stage, the snapshot lands in a bounded per-run history under
    ``run_id`` — re-merging the same run *replaces* its prior
    contribution (a repeated flush is a no-op; a later, larger flush of
    the same run supersedes, never double-counts) — and the cross-run
    ``legs`` aggregate is re-pooled.  Atomic write (tmp + ``os.replace``)
    serialized in-process; never raises — persisting the model must not
    take down whatever produced it."""
    path = path or cost_model_path()
    try:
        with _persist_lock:
            doc = load_cost_model(path)
            bank = doc["stages"]
            for key, snap in stages.items():
                entry = bank.get(key)
                if entry is None:
                    entry = bank[key] = {"runs": {}}
                for attr in ("pipeline", "node", "bucket", "mesh",
                             "flops_per_frame", "bytes_per_frame"):
                    if snap.get(attr) is not None:
                        entry[attr] = snap[attr]
                runs = entry.setdefault("runs", {})
                runs[run_id] = {
                    "legs": {leg: dict(stat)
                             for leg, stat in (snap.get("legs") or {}).items()},
                    "updated_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                }
                while len(runs) > MAX_RUNS:
                    oldest = min(runs, key=lambda r: (runs[r].get(
                        "updated_at", ""), r))
                    del runs[oldest]
                _pool_runs(entry)
                entry["updated_at"] = time.strftime("%Y-%m-%d %H:%M:%S")
            doc["updated_at"] = time.strftime("%Y-%m-%d %H:%M:%S")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            return doc
    except Exception:  # noqa: BLE001
        import logging

        logging.getLogger("nnstreamer_tpu_torch.obs").exception(
            "cost-model merge failed (path=%s)", path)
        return {"schema": SCHEMA_VERSION, "stages": dict(stages)}


def stage_key(pipeline: str, node: str, bucket: int = 0,
              mesh: int = 1) -> str:
    return f"{pipeline}|{node}|b{bucket}|mesh{mesh}"


# -- the tracer ---------------------------------------------------------------

# live tracers by pipeline name: the process-wide "cost_model" stats
# provider merges them (a stopped tracer stays readable until a new
# tracer for the same pipeline replaces it)
_live_lock = threading.Lock()
_live: Dict[str, "CostModelTracer"] = {}
_provider_registered = False


def live_summaries() -> dict:
    """Summaries of every live (or stopped-but-readable) tracer in this
    process, by pipeline name — the ``cost_model`` stats provider, also
    embedded per-worker in fleet ``/stats.json`` sections."""
    with _live_lock:
        tracers = dict(_live)
    return {name: t.summary() for name, t in tracers.items()}


def _stats_provider() -> dict:
    return live_summaries()


class CostModelTracer(Tracer):
    """Per-stage compute-vs-transfer cost model on the hook bus.

    See the module docstring for the leg definitions.  Attribution is
    observer-grade: a leg whose feed is absent for a node (no device
    dispatches, no copies) simply has no samples — never a zero that
    reads as "measured free".
    """

    name = "costmodel"
    QSTAMP_CAP = 4096  # per-queue FIFO bound: a wedged queue must not
    #                    grow tracer memory without bound

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 alpha: Optional[float] = None):
        super().__init__(registry)
        self._alpha = alpha
        self._lock = threading.Lock()
        # node -> {"legs": {leg: LegStat}, "bucket": int, "mesh": int,
        #          "frames": int, "flops": float|None, "bytes": float|None,
        #          "copy_bytes": int}
        self._stages: Dict[str, dict] = {}
        # queue-residency stamp FIFOs: queue name -> deque of push ts_ns,
        # plus the upstream-leak skip count (a leaky "upstream" drop
        # emits queue_push without enqueuing anything)
        self._qstamps: Dict[str, "collections.deque"] = {}
        self._qskip: Dict[str, int] = {}
        # pops owed a stamp: the queue makes an item poppable BEFORE its
        # queue_push hook fires, so a fast consumer's pop can arrive
        # first — that pop is counted as ~0 residency and the late stamp
        # retired here, keeping the FIFO pairing exact
        self._qowed: Dict[str, int] = {}
        self._gauge = None
        self._collect_handle = None
        self._run_id = f"{os.getpid()}-{id(self):x}-{now_ns():x}"

    # -- lifecycle -----------------------------------------------------------

    def _install(self) -> None:
        global _provider_registered
        if self._alpha is None:
            self._alpha = configured_alpha()
        self._gauge = self._registry.gauge(
            "nnstpu_stage_cost_us",
            "Windowed EWMA of per-frame stage cost by leg (µs): host "
            "dispatch, true device execution, queue wait, and estimated "
            "wire transfer ([obs] costmodel_alpha smoothing)",
            labelnames=("pipeline", "node", "leg"),
        )
        self._collect_handle = self._registry.add_collector(self._collect)
        self._connect("dispatch_exit", self._on_dispatch_exit)
        self._connect("device_exec", self._on_device_exec)
        self._connect("queue_push", self._on_queue_push)
        self._connect("queue_pop", self._on_queue_pop)
        self._connect("queue_drop", self._on_queue_drop)
        self._connect("copy", self._on_copy)
        with _live_lock:
            _live[self._pipeline.name] = self
            first = not _provider_registered
            _provider_registered = True
        if first:
            from .export import register_stats

            register_stats("cost_model", _stats_provider)

    def stop(self) -> None:
        was_active = bool(self._conns)
        super().stop()
        if not was_active:
            return
        if self._collect_handle is not None:
            # one final gauge refresh, then detach: the series stays
            # present (CI scrapes after the run) without a collector
            # reading dead state forever
            self._collect()
            self._registry.remove_collector(self._collect_handle)
            self._collect_handle = None
        if configured_autosave():
            self.flush()

    # -- hook callbacks ------------------------------------------------------

    def _stage(self, node_name: str) -> dict:
        st = self._stages.get(node_name)
        if st is None:
            st = self._stages[node_name] = {
                "legs": {}, "bucket": 0, "mesh": 1, "frames": 0,
                "flops": None, "bytes": None, "copy_bytes": 0,
            }
        return st

    def _leg(self, node_name: str, leg: str, us: float) -> None:
        with self._lock:
            st = self._stage(node_name)
            stat = st["legs"].get(leg)
            if stat is None:
                stat = st["legs"][leg] = LegStat()
            stat.add(us, self._alpha)

    def _on_dispatch_exit(self, node, pad, item, dur_ns) -> None:
        del pad
        if node.pipeline is not self._pipeline:
            return
        if getattr(item, "tensors", None) is None:
            return  # in-band events are not per-frame cost
        with self._lock:
            self._stage(node.name)["frames"] += 1
        self._leg(node.name, "dispatch", dur_ns / 1e3)

    def _on_device_exec(self, pipeline_name, node_name, device, t0_ns,
                        dur_ns, info) -> None:
        del device, t0_ns
        if pipeline_name != self._pipeline.name:
            return
        self._leg(node_name, "device_exec", dur_ns / 1e3)
        with self._lock:
            st = self._stage(node_name)
            if info.get("bucket"):
                st["bucket"] = int(info["bucket"])
            if info.get("mesh"):
                st["mesh"] = int(info["mesh"])
            if info.get("flops"):
                st["flops"] = float(info["flops"])
            if info.get("bytes"):
                st["bytes"] = float(info["bytes"])

    def _on_queue_push(self, node, depth) -> None:
        del depth
        if node.pipeline is not self._pipeline:
            return
        with self._lock:
            if self._qskip.get(node.name, 0) > 0:
                # the preceding "upstream" leaky drop rejected the item
                # before it entered the queue; this push changed nothing
                self._qskip[node.name] -= 1
                return
            if self._qowed.get(node.name, 0) > 0:
                # the item's pop already raced past this hook and was
                # sampled as ~0 residency — retire the debt instead of
                # stamping, so later pops pair with their own pushes
                self._qowed[node.name] -= 1
                return
            dq = self._qstamps.get(node.name)
            if dq is None:
                dq = self._qstamps[node.name] = collections.deque(
                    maxlen=self.QSTAMP_CAP)
            dq.append(now_ns())

    def _on_queue_pop(self, node, depth) -> None:
        del depth
        if node.pipeline is not self._pipeline:
            return
        with self._lock:
            dq = self._qstamps.get(node.name)
            stamp = dq.popleft() if dq else None
            if stamp is None:
                # no stamp yet: this pop overtook its push hook, so the
                # residency was below the hook gap — a TRUE ~0, not an
                # unmeasured leg (the push/pop pair did happen)
                self._qowed[node.name] = self._qowed.get(node.name, 0) + 1
        if stamp is not None:
            self._leg(node.name, "queue_wait", max(0, now_ns() - stamp) / 1e3)
        else:
            self._leg(node.name, "queue_wait", 0.0)

    def _on_queue_drop(self, node, reason) -> None:
        if node.pipeline is not self._pipeline:
            return
        with self._lock:
            if reason == "upstream":
                # incoming item rejected pre-push: swallow the queue_push
                # emission that follows it
                self._qskip[node.name] = self._qskip.get(node.name, 0) + 1
            else:
                # "downstream"/"recovery": an already-queued item left
                # without a pop — retire its (oldest) stamp
                dq = self._qstamps.get(node.name)
                if dq:
                    dq.popleft()

    def _on_copy(self, node, nbytes, allocs) -> None:
        del allocs
        pipeline = getattr(node, "pipeline", None)
        if pipeline is not None and pipeline is not self._pipeline:
            return
        name = getattr(node, "name", None) or type(node).__name__
        with self._lock:
            self._stage(name)["copy_bytes"] += int(nbytes)
        wire = _util.last_wire_health()
        put_ms = (wire or {}).get("put_150k_ms")
        if put_ms is not None:
            # price the staged bytes at the live probe's put rate —
            # an estimate, clearly labeled as one in the snapshot
            self._leg(name, "wire", float(put_ms) * 1e3
                      * (int(nbytes) / _PROBE_NBYTES))

    # -- export --------------------------------------------------------------

    def _collect(self) -> None:
        with self._lock:
            snap = [(node, leg, stat.ewma_us)
                    for node, st in self._stages.items()
                    for leg, stat in st["legs"].items()]
        for node, leg, ewma in snap:
            self._gauge.set(round(ewma, 3), pipeline=self._pipeline.name,
                            node=node, leg=leg)

    def stage_snapshots(self) -> Dict[str, dict]:
        """{stage key: persistable snapshot} — the merge_cost_model
        input (stage keys carry the observed bucket/mesh geometry)."""
        pipeline = self._pipeline.name if self._pipeline is not None else ""
        out: Dict[str, dict] = {}
        with self._lock:
            for node, st in self._stages.items():
                if not st["legs"]:
                    continue
                key = stage_key(pipeline, node, st["bucket"], st["mesh"])
                frames = st["frames"] or max(
                    (s.count for s in st["legs"].values()), default=0)
                snap = {
                    "pipeline": pipeline,
                    "node": node,
                    "bucket": st["bucket"],
                    "mesh": st["mesh"],
                    "legs": {leg: stat.snapshot()
                             for leg, stat in st["legs"].items()},
                }
                if st["flops"] is not None:
                    snap["flops_per_frame"] = st["flops"]
                if st["bytes"] is not None:
                    snap["bytes_per_frame"] = st["bytes"]
                if frames and st["copy_bytes"]:
                    snap["copy_bytes_per_frame"] = round(
                        st["copy_bytes"] / frames, 1)
                out[key] = snap
        return out

    def flush(self, path: Optional[str] = None) -> dict:
        """Persist this tracer's snapshots (idempotent per run — safe
        to call repeatedly); returns the merged document."""
        return merge_cost_model(self.stage_snapshots(), self._run_id,
                                path=path)

    def summary(self) -> dict:
        """The ``cost_model`` stats/``pipeline.stats()`` view: per node,
        every leg's EWMA/mean plus the compute-vs-transfer split."""
        out: Dict[str, dict] = {}
        with self._lock:
            for node, st in self._stages.items():
                legs = {leg: stat.snapshot()
                        for leg, stat in st["legs"].items()}
                entry = {
                    "bucket": st["bucket"],
                    "mesh": st["mesh"],
                    "frames": st["frames"],
                    "legs": legs,
                }
                compute = legs.get("device_exec", {}).get("ewma_us")
                transfer = legs.get("wire", {}).get("ewma_us")
                if compute is not None or transfer is not None:
                    entry["compute_us"] = compute
                    entry["transfer_us"] = transfer
                    if compute and transfer is not None:
                        entry["transfer_ratio"] = round(
                            transfer / (compute + transfer), 4)
                if st["copy_bytes"]:
                    entry["copy_bytes"] = st["copy_bytes"]
                if st["flops"] is not None:
                    entry["flops_per_frame"] = st["flops"]
                if st["bytes"] is not None:
                    entry["bytes_per_frame"] = st["bytes"]
                out[node] = entry
        return {"run_id": self._run_id, "alpha": self._alpha,
                "stages": out, "wire_estimate": "copy bytes priced at "
                "the last wire-health put rate"}


# self-registration (obs/__init__ imports this module, so
# NNSTPU_TRACERS=costmodel / attach_tracer("costmodel") always resolve)
from .tracers import TRACERS  # noqa: E402

TRACERS[CostModelTracer.name] = CostModelTracer
