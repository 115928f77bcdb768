"""Cluster observability: cross-process trace collection + federation.

The port of the JAX package's ``obs/collector.py``; its documents are the
JAX package's, so a collector of either package merges the other's
``/trace.json`` and ``/alerts``.  Every process has flight-recorder spans
and Prometheus metrics, and a fleet spreads serving across processes.
This module is the layer that puts the pieces back together into ONE
picture:

- every process exposes its flight-recorder snapshot at ``/trace.json``
  (served by :class:`~nnstreamer_tpu_torch.obs.export.MetricsServer`, next to
  ``/healthz`` and ``/stats.json``) — see :func:`trace_document`;
- :class:`TraceCollector` federates those snapshots into a single
  Perfetto trace: one ``pid`` per process, records aligned onto the
  collector's clock so a request's ``nnsq_rtt`` (client) →
  ``nnsq_route`` (router) → ``nnsq_serve`` (worker) → ``device_exec``
  spans nest on one timeline, joined by the NNSQ trace context that
  already crosses the wire;
- :func:`federate_metrics` merges per-worker ``/metrics`` expositions
  into one document with a ``worker`` label, so one scrape (or one
  file) carries the whole fleet;
- :func:`attribute_trace` decomposes one request's joined spans into
  latency legs (queue wait / dispatch / device / wire) — the primitive
  under the loadgen report (``tools/loadgen.py``).

**Clock alignment.**  Span timestamps are ``time.perf_counter_ns()``
values — monotonic, but with a *per-process arbitrary epoch*, so two
processes' records can be offset by their relative start times (minutes,
not microseconds).  The collector therefore estimates each source's
clock offset the NTP way: probe the source's clock several times, take
the probe with the smallest RTT, and assume the remote read happened at
the probe's midpoint — ``offset = remote_clock − (t0 + t1) / 2``.
Aligned timestamp: ``local_ts = remote_ts − offset``.  The residual
error is bounded by half the best probe's RTT (microseconds on
localhost, well under the span durations being nested).

A source that fails to answer (a killed worker, a partitioned pod) is
reported in the merge result's ``errors`` — the merged trace stays a
valid Perfetto document built from the processes that DID answer, so a
partial fleet still yields a usable timeline.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from . import spans as _spans

_process_name_lock = threading.Lock()
_process_name: Optional[str] = None


def set_process_name(name: str) -> None:
    """Name this process in its ``/trace.json`` document (fleet CLI
    workers/routers call this so the merged trace reads ``worker-0``,
    not ``pid4711``)."""
    global _process_name
    with _process_name_lock:
        _process_name = str(name)


def process_name() -> str:
    with _process_name_lock:
        if _process_name is not None:
            return _process_name
    return f"pid{os.getpid()}"


def trace_document(clock_only: bool = False) -> dict:
    """The ``/trace.json`` body: this process's flight snapshot plus the
    clock stamp the collector aligns against.  ``clock_only=True`` is the
    cheap offset-estimation probe (no snapshot copy)."""
    doc = {
        "process": process_name(),
        "pid": os.getpid(),
        "clock_ns": _spans.now_ns(),
    }
    if not clock_only:
        doc["records"] = [list(r) for r in _spans.snapshot()]
        doc["recorder"] = _spans.recorder_stats()
        # re-stamp AFTER the snapshot copy: the stamp then sits closest
        # to the freshest records (snapshotting can take milliseconds)
        doc["clock_ns"] = _spans.now_ns()
    return doc


def estimate_clock_offset(clock_fn: Callable[[], int],
                          samples: int = 5) -> Tuple[int, int]:
    """``(offset_ns, rtt_ns)`` of a remote clock vs the local span clock.

    ``clock_fn`` reads the remote process's ``perf_counter_ns`` (over
    HTTP or in-process); the best-of-``samples`` probe (minimum RTT) is
    trusted, and the remote read is assumed to have happened at that
    probe's midpoint — the classic NTP estimate, bounded by rtt/2.
    """
    best: Optional[Tuple[int, int]] = None  # (rtt, offset)
    for _ in range(max(1, int(samples))):
        t0 = _spans.now_ns()
        remote = int(clock_fn())
        t1 = _spans.now_ns()
        rtt = t1 - t0
        offset = remote - (t0 + t1) // 2
        if best is None or rtt < best[0]:
            best = (rtt, offset)
    return best[1], best[0]


class TraceSource:
    """One process's trace feed: a fetch callable + a clock callable.

    ``offset_ns`` is remote-clock minus collector-clock (estimated at
    registration, refreshable via :meth:`sync`); aligned record
    timestamps are ``remote_ts - offset_ns``.
    """

    def __init__(self, name: str, fetch: Callable[[], dict],
                 clock: Optional[Callable[[], int]] = None,
                 probes: int = 5):
        self.name = str(name)
        self._fetch = fetch
        self._clock = clock
        self.offset_ns = 0
        self.rtt_ns = 0
        self.probes = int(probes)
        if clock is not None:
            self.sync()

    def sync(self) -> None:
        """(Re-)estimate the clock offset; raises if the clock probe
        fails (the caller records the source as erroring)."""
        if self._clock is not None:
            self.offset_ns, self.rtt_ns = estimate_clock_offset(
                self._clock, self.probes)

    def fetch(self) -> dict:
        return self._fetch()


def http_get_json(url: str, timeout_s: float) -> dict:
    """GET ``url`` and decode its JSON body."""
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def http_source(name: str, addr: str, probes: int = 5,
                timeout_s: float = 5.0) -> TraceSource:
    """A :class:`TraceSource` over a worker's metrics endpoint
    (``addr = "host:port"``): fetches ``/trace.json``, probes
    ``/trace.json?clock=1`` for the offset."""
    base = f"http://{addr}/trace.json"

    def fetch() -> dict:
        return http_get_json(base, timeout_s)

    def clock() -> int:
        return int(http_get_json(f"{base}?clock=1", timeout_s)["clock_ns"])

    return TraceSource(name, fetch, clock, probes=probes)


class TraceCollector:
    """Federate N processes' flight snapshots into one aligned trace."""

    def __init__(self):
        self._sources: List[TraceSource] = []

    # -- registration --------------------------------------------------------

    def add_source(self, source: TraceSource) -> TraceSource:
        self._sources.append(source)
        return source

    def add_local(self, name: Optional[str] = None) -> TraceSource:
        """This process's own recorder (offset 0 by construction) — the
        loadgen/collector process itself, or an in-process fleet where
        router and workers share one recorder."""
        return self.add_source(TraceSource(
            name or process_name(), lambda: trace_document(), clock=None))

    def add_http(self, name: str, addr: str, probes: int = 5,
                 timeout_s: float = 5.0) -> TraceSource:
        """A subprocess worker/router by its metrics-server address."""
        return self.add_source(http_source(name, addr, probes=probes,
                                           timeout_s=timeout_s))

    def add_fleet(self, membership) -> List[TraceSource]:
        """Every fleet member that exposes a health/metrics endpoint
        (:meth:`nnstreamer_tpu_torch.fleet.Membership.trace_sources`)."""
        return [self.add_http(wid, addr)
                for wid, addr in membership.trace_sources().items()]

    def sources(self) -> List[TraceSource]:
        return list(self._sources)

    # -- collection ----------------------------------------------------------

    def collect(self) -> dict:
        """Fetch + align every source.  Returns::

            {"sources": {name: {"records": [...aligned...],
                                "offset_ns": int, "rtt_ns": int,
                                "pid": int, "process": str}},
             "errors": {name: "repr(exc)"}}

        A source that fails to fetch (killed worker, partition) lands in
        ``errors`` and the merge proceeds without it — a partial fleet
        still produces a valid trace.
        """
        out: Dict[str, dict] = {}
        errors: Dict[str, str] = {}
        for src in self._sources:
            try:
                src.sync()
                doc = src.fetch()
                offset = src.offset_ns
                records = [
                    tuple([r[0], int(r[1]) - offset] + list(r[2:]))
                    for r in doc.get("records", ())
                ]
                out[src.name] = {
                    "records": records,
                    "offset_ns": offset,
                    "rtt_ns": src.rtt_ns,
                    "pid": doc.get("pid", 0),
                    "process": doc.get("process", src.name),
                    "recorder": doc.get("recorder", {}),
                }
            except Exception as exc:  # noqa: BLE001 — partial trace > no trace
                errors[src.name] = repr(exc)
        return {"sources": out, "errors": errors}

    def chrome_trace(self, collected: Optional[dict] = None) -> dict:
        """One Perfetto/chrome-tracing document for the whole cluster:
        one ``pid`` per source (named by its process), every record
        already shifted onto the collector's clock so spans from
        different processes nest by plain time containment."""
        if collected is None:
            collected = self.collect()
        merged: List[dict] = []
        for i, (name, entry) in enumerate(
                sorted(collected["sources"].items())):
            doc = _spans.chrome_trace(entry["records"], pid=i + 1,
                                      process_name=name)
            for ev in doc["traceEvents"]:
                # flow ids are per-process counters: namespace them per
                # source so arrows never connect across unrelated pids
                if ev.get("ph") in ("s", "f"):
                    ev["id"] = int(ev["id"]) + ((i + 1) << 40)
                merged.append(ev)
        merged.extend(self._hop_flows(merged))
        if collected["errors"]:
            # the missing processes are part of the story: record them
            # as metadata instants instead of silently narrowing scope
            for name, err in sorted(collected["errors"].items()):
                merged.append({
                    "ph": "i", "ts": 0, "pid": 0, "tid": 0, "s": "g",
                    "name": f"source_missing:{name}", "cat": "collector",
                    "args": {"error": err},
                })
        doc = {"traceEvents": merged, "displayTimeUnit": "ms"}
        try:
            # the deep-profiling lane's drill-down: the most recent
            # capture's top-K op table rides under otherData and every
            # matching device_exec span gets a profile_capture arg — the
            # "which fused op" answer next to the span that asked it
            from .profiler import annotate_chrome_trace

            annotate_chrome_trace(doc)
        except Exception:  # noqa: BLE001 — annotation is best-effort
            pass
        return doc

    @staticmethod
    def _hop_flows(merged: List[dict]) -> List[dict]:
        """Synthesize client→server flow arrows for cross-process NNSQ
        hops: a server-side envelope span (``nnsq_serve``/``nnsq_route``)
        whose wire-carried parent is an ``nnsq_rtt`` span in a DIFFERENT
        process gets an ``nnsq_hop`` ``s``→``f`` pair from the client's
        rtt row to the server's row.  Per-source flow ids never cross
        pids by design (they are namespaced), so the partition edge —
        the one hop that IS cross-process — draws its arrows here."""
        by_key: Dict[Tuple[Optional[str], str], dict] = {}
        for ev in merged:
            if ev.get("ph") == "X":
                a = ev.get("args") or {}
                if a.get("span_id"):
                    by_key[(a.get("trace_id"), a["span_id"])] = ev
        hops: List[dict] = []
        for ev in merged:
            if ev.get("ph") != "X" or ev.get("name") not in (
                    "nnsq_serve", "nnsq_route"):
                continue
            a = ev.get("args") or {}
            parent = by_key.get((a.get("trace_id"), a.get("parent_id")))
            if parent is None or parent.get("name") != "nnsq_rtt" \
                    or parent["pid"] == ev["pid"]:
                continue
            # hop flow ids live above every per-source namespace
            fid = (1 << 52) + len(hops) // 2 + 1
            args = {"edge": (parent.get("args") or {}).get("edge", "")}
            hops.append({"ph": "s", "id": fid, "pid": parent["pid"],
                         "tid": parent["tid"], "ts": parent["ts"],
                         "name": "nnsq_hop", "cat": "partition",
                         "args": args})
            hops.append({"ph": "f", "bp": "e", "id": fid, "pid": ev["pid"],
                         "tid": ev["tid"],
                         "ts": max(ev["ts"], parent["ts"]),
                         "name": "nnsq_hop", "cat": "partition",
                         "args": args})
        return hops

    def spans_by_trace(self, collected: Optional[dict] = None
                       ) -> Dict[int, List[tuple]]:
        """Join index: trace_id → every aligned complete-span record for
        it across all sources (record layout as in ``obs/flight.py``,
        with the source name appended as field 10)."""
        if collected is None:
            collected = self.collect()
        index: Dict[int, List[tuple]] = {}
        for name, entry in collected["sources"].items():
            for r in entry["records"]:
                if r[0] == _spans.PH_COMPLETE and r[6]:
                    index.setdefault(int(r[6]), []).append(tuple(r) + (name,))
        for recs in index.values():
            recs.sort(key=lambda r: r[1])
        return index


# span name → latency leg (the decomposition the loadgen report emits)
SPAN_LEGS = {
    "nnsq_rtt": "rtt",
    "nnsq_route": "route",
    "nnsq_serve": "serve",
    "sched_wait": "queue",
    "slot_wait": "queue",
    "device_invoke": "device",
    "device_exec": "device",
    # dead-time spans from the device utilization lane (obs/device.py):
    # how long the card sat starved before this trace's dispatch ran
    "device_idle": "device_idle",
}


def attribute_trace(records: List[tuple]) -> Dict[str, float]:
    """Decompose one trace's spans into latency legs (nanoseconds).

    Returns cumulative span durations per leg (``rtt``, ``route``,
    ``serve``, ``queue``, ``device``, ``device_idle``) plus the derived
    components used by SLO reports:

    - ``wire``: rtt − route (client↔router transport + stacks), falling
      back to rtt − serve when no router was in the path — only ever
      derived when a server-side envelope span actually joined;
    - ``unattributed``: the residual when the client RTT exceeds the
      sum of the server legs that joined.  When NEITHER ``route`` nor
      ``serve`` made it into the join (ring overflow, a worker flight
      that was never collected), the old behavior charged the entire
      RTT to ``wire`` — over-attribution that sent readers chasing
      tunnel ghosts.  Now the uncovered remainder (rtt − queue −
      device) is reported as explicitly UNKNOWN instead; the loadgen
      report surfaces it as ``unattributed_us``;
    - ``route_overhead``: route − serve (router forwarding cost);
    - ``dispatch``: serve − queue − device (worker-side serve time that
      is neither queue wait nor device execution);
    - ``device_idle``: device starvation observed before this trace's
      dispatch executed (``device_idle`` flight spans — the reason arg
      on the span says whether host dispatch, queue wait, or the wire
      starved the card);
    - ``hop:{edge}``: per partition edge, the cross-process transfer
      time of this trace's tagged round trips — each ``nnsq_rtt`` span
      carrying an ``edge`` arg (a ``tensor_query_client`` with
      ``edge=`` set) contributes its duration minus whatever server
      envelope joined UNDER it (children by wire-carried parent id), so
      a split pipeline's wire cost is attributed to its named edge
      instead of drowning in ``wire``/``unattributed``.

    Derived values clamp at 0 (ring overflow can drop inner spans).
    """
    legs: Dict[str, float] = {}
    for r in records:
        leg = SPAN_LEGS.get(r[4])
        if leg is not None:
            legs[leg] = legs.get(leg, 0.0) + float(r[2])
    for r in records:
        if r[4] != "nnsq_rtt" or not isinstance(r[9], dict):
            continue
        edge = r[9].get("edge")
        if not edge:
            continue
        covered = sum(float(c[2]) for c in records
                      if c[4] in ("nnsq_serve", "nnsq_route")
                      and c[8] == r[7])
        key = f"hop:{edge}"
        legs[key] = legs.get(key, 0.0) + max(0.0, float(r[2]) - covered)
    rtt = legs.get("rtt", 0.0)
    route = legs.get("route", 0.0)
    serve = legs.get("serve", 0.0)
    queue = legs.get("queue", 0.0)
    device = legs.get("device", 0.0)
    if rtt:
        envelope = route or serve
        if envelope:
            legs["wire"] = max(0.0, rtt - envelope)
        else:
            # no server envelope joined: the gap is unknown, not wire
            legs["unattributed"] = max(0.0, rtt - queue - device)
    if route:
        legs["route_overhead"] = max(0.0, route - serve)
    if serve:
        legs["dispatch"] = max(0.0, serve - queue - device)
    return legs


# -- metrics federation ------------------------------------------------------

def _inject_label(line: str, label: str, value: str) -> str:
    """``name{a="b"} 1`` / ``name 1`` → the same sample with
    ``label="value"`` prepended to the label set."""
    # an OpenMetrics exemplar suffix (` # {trace_id="..."} v ts`) rides
    # after the sample value: detach it first — its braces must not be
    # mistaken for the sample's label set — and reattach untouched
    line, ex_sep, exemplar = line.partition(" # {")
    suffix = ex_sep + exemplar if ex_sep else ""
    # split the sample into name[{labels}] and the value suffix
    brace = line.find("{")
    esc = value.replace("\\", r"\\").replace('"', r'\"')
    if brace != -1:
        close = line.rfind("}")
        inner = line[brace + 1:close]
        rest = line[close + 1:]
        joined = f'{label}="{esc}"' + ("," + inner if inner else "")
        return f"{line[:brace]}{{{joined}}}{rest}{suffix}"
    sp = line.find(" ")
    if sp == -1:
        return line + suffix  # not a sample line; pass through untouched
    return f'{line[:sp]}{{{label}="{esc}"}}{line[sp:]}{suffix}'


def federate_metrics(sources: Dict[str, str],
                     label: str = "worker") -> str:
    """Merge N Prometheus text expositions into one, tagging every
    sample with ``label="<source name>"`` — the single-scrape view of a
    whole fleet.  ``sources`` maps source name → exposition text
    (callers fetch ``/metrics`` however they like; see
    :func:`fetch_metrics` for the HTTP helper).  ``# HELP``/``# TYPE``
    headers are emitted once per metric, and every metric's samples are
    grouped under its header (the exposition-format contract)."""
    headers: Dict[str, List[str]] = {}
    samples: Dict[str, List[str]] = {}
    order: List[str] = []
    for name, text in sources.items():
        current = ""
        for line in (text or "").splitlines():
            line = line.rstrip()
            if not line:
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                metric = line.split(" ", 3)[2]
                if metric not in headers:
                    headers[metric] = []
                    order.append(metric)
                    samples.setdefault(metric, [])
                if line not in headers[metric]:
                    headers[metric].append(line)
                current = metric
                continue
            if line.startswith("#"):
                continue
            if not current:
                # headerless sample (unusual but legal): own group keyed
                # by the bare metric name
                current = line.split("{", 1)[0].split(" ", 1)[0]
                if current not in samples:
                    order.append(current)
                    headers.setdefault(current, [])
                    samples.setdefault(current, [])
            samples.setdefault(current, []).append(
                _inject_label(line, label, name))
    lines: List[str] = []
    for metric in order:
        lines.extend(headers.get(metric, ()))
        lines.extend(samples.get(metric, ()))
    return "\n".join(lines) + ("\n" if lines else "")


def merge_alerts(docs: Dict[str, dict]) -> dict:
    """Fold per-worker ``/alerts`` documents (see
    :meth:`nnstreamer_tpu_torch.obs.slo.SloEngine.alerts_document`) into ONE
    fleet-wide view: each objective's per-window good/total deltas are
    summed across workers and the burn rate recomputed from the pooled
    counts — so the router sees the fleet burning even when every
    individual worker sits just under its threshold.  An objective also
    reads firing fleet-wide when ANY member fires (a single saturated
    worker is an alert, not an average)."""
    merged: Dict[str, dict] = {}
    for worker, doc in sorted(docs.items()):
        for name, obj in (doc.get("objectives") or {}).items():
            ent = merged.get(name)
            if ent is None:
                ent = merged[name] = {
                    "metric": obj.get("metric"),
                    "labels": obj.get("labels") or {},
                    "bound_ms": obj.get("bound_ms"),
                    "target": obj.get("target"),
                    "windows": {},
                    "workers": [],
                    "workers_firing": [],
                }
            ent["workers"].append(worker)
            if obj.get("state") == "firing":
                ent["workers_firing"].append(worker)
            for wname, win in (obj.get("windows") or {}).items():
                agg = ent["windows"].setdefault(wname, {
                    "window_s": win.get("window_s"),
                    "threshold": win.get("threshold"),
                    "good": 0.0, "total": 0.0,
                })
                agg["good"] += float(win.get("good") or 0.0)
                agg["total"] += float(win.get("total") or 0.0)
    firing: List[str] = []
    for name, ent in merged.items():
        budget = max(1e-9, 1.0 - float(ent.get("target") or 0.0))
        is_firing = bool(ent["workers_firing"])
        for win in ent["windows"].values():
            total = win["total"]
            bad = max(0.0, total - win["good"])
            win["burn"] = round((bad / total) / budget, 4) if total else 0.0
            thr = win.get("threshold")
            if thr is not None and win["burn"] >= float(thr):
                is_firing = True
        ent["state"] = "firing" if is_firing else "ok"
        if is_firing:
            firing.append(name)
    return {"objectives": merged, "firing": sorted(firing),
            "workers": sorted(docs)}


def fetch_alerts(addrs: Dict[str, str], timeout_s: float = 5.0) -> dict:
    """HTTP convenience over :func:`merge_alerts`: fetch every worker's
    ``/alerts`` and merge.  Unreachable workers land in ``errors``; the
    merged view is built from whoever answered."""
    docs: Dict[str, dict] = {}
    errors: Dict[str, str] = {}
    for name, addr in addrs.items():
        try:
            docs[name] = http_get_json(
                f"http://{addr}/alerts", timeout_s)
        except Exception as exc:  # noqa: BLE001 — a dead worker != no merge
            errors[name] = repr(exc)
    merged = merge_alerts(docs)
    if errors:
        merged["errors"] = errors
    return merged


def fetch_profile(addr: str, seconds: Optional[float] = None,
                  frames: Optional[int] = None,
                  timeout_s: float = 60.0) -> dict:
    """Trigger a deep-profiling capture on a remote worker
    (``GET /profile`` on its metrics address — the same trace-addr
    plumbing the collector federates traces over) and return the parsed
    summary.  The endpoint blocks for the capture window, so
    ``timeout_s`` must exceed it.  A busy worker (HTTP 409) raises
    :class:`~nnstreamer_tpu_torch.obs.profiler.ProfileBusyError`."""
    import urllib.error

    params = []
    if seconds is not None:
        params.append(f"seconds={seconds}")
    if frames is not None:
        params.append(f"frames={frames}")
    url = f"http://{addr}/profile" + (
        "?" + "&".join(params) if params else "")
    try:
        return http_get_json(url, timeout_s)
    except urllib.error.HTTPError as exc:
        if exc.code == 409:
            from .profiler import ProfileBusyError

            try:
                active = json.loads(exc.read().decode("utf-8")).get("active")
            except Exception:  # noqa: BLE001 — body is advisory
                active = None
            raise ProfileBusyError(active) from exc
        raise


def fetch_metrics(addrs: Dict[str, str], timeout_s: float = 5.0,
                  label: str = "worker") -> str:
    """HTTP convenience over :func:`federate_metrics`: ``addrs`` maps
    worker name → ``host:port`` of its metrics server.  Unreachable
    workers contribute a ``nnstpu_federation_scrape_failed`` marker
    series instead of failing the whole scrape."""
    texts: Dict[str, str] = {}
    for name, addr in addrs.items():
        try:
            with urllib.request.urlopen(
                    f"http://{addr}/metrics", timeout=timeout_s) as resp:
                texts[name] = resp.read().decode("utf-8")
        except Exception:  # noqa: BLE001 — a dead worker != no federation
            texts[name] = (
                "# TYPE nnstpu_federation_scrape_failed gauge\n"
                "nnstpu_federation_scrape_failed 1\n")
    return federate_metrics(texts, label=label)
