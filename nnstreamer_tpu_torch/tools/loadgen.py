"""Production load harness: open-loop NNSQ client fleets, SLO reports.

The port of the JAX package's ``tools/loadgen.py``: the same arrival
schedules bit for bit for the same seed and profile, the same scenarios and
the same report, over a fleet of the port's workers (on the card by
default; ``--device cpu`` on the host).  The serving processes have rich
per-process metrics and spans and a fleet spreads them over processes;
this tool generates production-shaped load against it and turns the
instrumentation into answers:

- **open-loop arrivals** (Poisson thinning over a time-varying rate, or
  recorded-trace replay): request launch times are drawn ahead of time
  and latency is measured from the *scheduled* arrival, so queueing
  delay is measured instead of hidden (a closed-loop client slows down
  exactly when the server does — the classic coordinated-omission trap);
- **per-tenant workload mixes** (vision single-shot, SSD cascade, LSTM
  window, continuous-batch decode with prefill bursts, plus the ``vit``
  / ``audio_cnn`` / ``text_classifier`` model scenarios) with ramp /
  spike / diurnal offered-load profiles, each tenant declaring its
  identity on the wire (``FLAG_TENANT``) so server-side admission and
  the ``tenant``-labeled metrics see the same split this report does;
- a machine-readable **report** (``BENCH_*``-style JSON): client-side
  p50/p99/p99.9 vs offered load (windowed curves), per-tenant goodput
  under overload (one flooding tenant + N well-behaved tenants — does
  DRR + admission + deadline expiry hold the well-behaved p99?), an
  exact request ledger (client counts vs the router's
  offered == delivered + shed), and per-trace latency **attribution**
  (queue wait / dispatch / device / wire) from joining client records
  with collected server spans by NNSQ trace id
  (:mod:`nnstreamer_tpu_torch.obs.collector`);
- a **CI SLO gate**: ``--scenario ci-slo --assert-slo`` runs a fixed
  seeded scenario against an in-process 2-worker fleet and exits
  non-zero when a check fails.

Usage::

    python -m nnstreamer_tpu_torch.tools.loadgen --list
    python -m nnstreamer_tpu_torch.tools.loadgen --scenario ci-slo \\
        --assert-slo --device cpu --out r.json
    python -m nnstreamer_tpu_torch.tools.loadgen --scenario mix \\
        --duration 5 --perfetto t.json
    python -m nnstreamer_tpu_torch.tools.loadgen --connect 127.0.0.1:7000 \\
        --workload vision \\
        --rate 50 --duration 10 --trace-source w0=127.0.0.1:9464
    python -m nnstreamer_tpu_torch.tools.loadgen --replay arrivals.json \\
        --connect ...

Replay files are JSON: ``[{"t": 0.01, "tenant": "a", "workload":
"vision"}, ...]`` (offsets in seconds from run start).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..elements.query import (
    QueryError,
    recv_tensors_ex,
    send_tensors,
)
from ..obs import forensics as _forensics
from ..obs import spans as _spans
from ..obs.collector import (
    TraceCollector,
    attribute_trace,
)


# -- percentiles (ceil-based nearest rank, the utils/profiling contract) ------

def pct(sorted_vals: Sequence[float], q: float) -> float:
    n = len(sorted_vals)
    if not n:
        return 0.0
    return float(sorted_vals[max(0, math.ceil(q * n) - 1)])


def summarize_ms(ns_vals: Sequence[float]) -> dict:
    """p50/p90/p99/p99.9 summary of nanosecond samples, in ms."""
    s = sorted(ns_vals)
    if not s:
        return {"count": 0}
    return {
        "count": len(s),
        "mean_ms": sum(s) / len(s) / 1e6,
        "p50_ms": pct(s, 0.50) / 1e6,
        "p90_ms": pct(s, 0.90) / 1e6,
        "p99_ms": pct(s, 0.99) / 1e6,
        "p999_ms": pct(s, 0.999) / 1e6,
        "max_ms": s[-1] / 1e6,
    }


# -- workloads ---------------------------------------------------------------

class Workload:
    """One request shape: ``kind="query"`` sends ``chain`` frames
    back-to-back on one connection (a cascade is 2 chained round trips);
    ``kind="decode"`` runs a stateful session — one prefill prompt, a
    burst of back-to-back steps (the prefill burst pattern), then paced
    steps.  ``payload(seq)`` (optional) gives the request's tensors-tuples
    instead of the filled ``chain`` shapes: real frames whose replies a
    caller checks."""

    def __init__(self, name: str, kind: str = "query",
                 chain: Optional[List[Tuple[tuple, np.dtype]]] = None,
                 prompt_len: int = 6, burst: int = 2, steps: int = 4,
                 gap_ms: float = 5.0,
                 payload: Optional[Callable[[int], List[tuple]]] = None):
        self.name = name
        self.kind = kind
        self.chain = chain or []
        self.prompt_len = prompt_len
        self.burst = burst
        self.steps = steps
        self.gap_ms = gap_ms
        self.payload = payload

    def frames(self, seq: int) -> List[tuple]:
        """Deterministic payloads (content is irrelevant to the serving
        path; shape is the contract) — one tensors-tuple per chained
        round trip."""
        if self.payload is not None:
            return list(self.payload(seq))
        out = []
        for shape, dtype in self.chain:
            fill = (seq % 7) + 1
            out.append((np.full(shape, fill, dtype=dtype),))
        return out


WORKLOADS: Dict[str, Callable[[], Workload]] = {
    # vision single-shot: one camera frame per request
    "vision": lambda: Workload(
        "vision", chain=[((1, 64, 64, 3), np.float32)]),
    # SSD cascade: detector pass then a cropped classifier pass, chained
    # on one connection (latency = the whole cascade)
    "ssd_cascade": lambda: Workload(
        "ssd_cascade", chain=[((1, 64, 64, 3), np.float32),
                              ((1, 32, 32, 3), np.float32)]),
    # LSTM window: one aggregator window of sensor samples
    "lstm_window": lambda: Workload(
        "lstm_window", chain=[((1, 16, 8), np.float32)]),
    # model-scenario shapes (served by the matching model fleets below)
    "vit": lambda: Workload("vit", chain=[((1, 32, 32, 3), np.float32)]),
    # audio_cnn serves one aggregator window per request (no batch dim:
    # the model's input_spec is the window itself)
    "audio_cnn": lambda: Workload(
        "audio_cnn", chain=[((512, 1), np.float32)]),
    "text_classifier": lambda: Workload(
        "text_classifier", chain=[((1, 64), np.uint8)]),
    # continuous-batch decode with a prefill burst
    "decode": lambda: Workload("decode", kind="decode", prompt_len=6,
                               burst=2, steps=4, gap_ms=5.0),
}


# -- offered-load profiles ---------------------------------------------------

def rate_fn(profile: dict) -> Tuple[Callable[[float], float], float]:
    """``(rate(t), peak_rate)`` for a profile spec:

    - ``{"kind": "constant", "rate": r}``
    - ``{"kind": "ramp", "lo": a, "hi": b}`` — linear over the run
    - ``{"kind": "spike", "rate": r, "peak": p, "at": frac, "width":
      frac}`` — base rate with a peak window
    - ``{"kind": "diurnal", "rate": r, "amp": a, "periods": n}`` —
      sinusoidal day/night cycles compressed into the run
    """
    kind = profile.get("kind", "constant")
    if kind == "constant":
        r = float(profile["rate"])
        return (lambda t: r), r
    if kind == "ramp":
        lo, hi = float(profile["lo"]), float(profile["hi"])
        return (lambda t: lo + (hi - lo) * t), max(lo, hi)
    if kind == "spike":
        base, peak = float(profile["rate"]), float(profile["peak"])
        at = float(profile.get("at", 0.5))
        width = float(profile.get("width", 0.2))

        def f(t: float) -> float:
            return peak if abs(t - at) <= width / 2 else base

        return f, max(base, peak)
    if kind == "diurnal":
        base = float(profile["rate"])
        amp = float(profile.get("amp", 0.5)) * base
        periods = float(profile.get("periods", 2))

        def f(t: float) -> float:
            return max(0.0, base + amp *
                       math.sin(2 * math.pi * periods * t))

        return f, base + amp
    raise ValueError(f"unknown profile kind {kind!r}")


def gen_arrivals(profile: dict, duration_s: float, seed: int) -> List[float]:
    """Seeded non-homogeneous Poisson arrivals over ``[0, duration_s)``
    via thinning (t is normalized to [0, 1) inside the profile)."""
    import random

    rng = random.Random(seed)
    f, peak = rate_fn(profile)
    if peak <= 0:
        return []
    out, t = [], 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= duration_s:
            return out
        if rng.random() <= f(t / duration_s) / peak:
            out.append(t)


def load_replay(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as fh:
        entries = json.load(fh)
    return sorted(entries, key=lambda e: float(e["t"]))


# -- the open-loop client fleet ----------------------------------------------

class _ConnPool:
    """Per-tenant socket pool to one address; typed server errors keep
    the socket (the stream stays in sync), transport errors drop it."""

    def __init__(self, addr: Tuple[str, int], timeout_s: float):
        self.addr = addr
        self.timeout_s = timeout_s
        self._idle: List[socket.socket] = []
        self._lock = threading.Lock()

    def get(self) -> socket.socket:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        sock = socket.create_connection(self.addr, timeout=self.timeout_s)
        sock.settimeout(self.timeout_s)
        return sock

    def put(self, sock: socket.socket) -> None:
        with self._lock:
            self._idle.append(sock)

    def drop(self, sock: socket.socket) -> None:
        try:
            sock.close()
        except OSError:
            pass

    def close_all(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for sock in idle:
            try:
                sock.close()
            except OSError:
                pass


class LoadGen:
    """Run one open-loop load session against an NNSQ endpoint."""

    def __init__(self, query_addr: Tuple[str, int],
                 tenants: List[dict], duration_s: float, seed: int = 7,
                 decode_addr: Optional[Tuple[str, int]] = None,
                 max_workers: int = 64, request_timeout_s: float = 30.0,
                 metric_pipeline: str = "loadgen", keep_replies: bool = False):
        """``keep_replies`` keeps each query record's replies (its
        ``replies``: one outputs tuple per delivered round trip) and its
        arrival ``seq``, for callers that check what was served."""
        self.query_addr = query_addr
        self.keep_replies = bool(keep_replies)
        self.decode_addr = decode_addr
        self.tenants = tenants
        self.duration_s = float(duration_s)
        self.seed = int(seed)
        self.max_workers = int(max_workers)
        self.request_timeout_s = float(request_timeout_s)
        self.records: List[dict] = []
        self._rec_lock = threading.Lock()
        self._pools: Dict[str, _ConnPool] = {}
        self.t0_ns = 0
        # client-observed round-trip latency into the same registry
        # histogram LatencyTracer feeds (sink="client" disambiguates),
        # observed INSIDE the rtt span so exemplars carry the trace id —
        # the series the SLO burn-rate engine (obs/slo.py) evaluates
        self.metric_pipeline = str(metric_pipeline)
        try:
            from ..obs.metrics import REGISTRY as _registry

            self._lat_hist = _registry.histogram(
                "nnstpu_e2e_latency_ms",
                "End-to-end per-frame source->sink latency (milliseconds)",
                labelnames=("pipeline", "src", "sink"))
        except ValueError:  # foreign registration; loadgen metrics are optional
            self._lat_hist = None

    def _pool(self, tenant: str, decode: bool) -> _ConnPool:
        key = f"{tenant}:{'d' if decode else 'q'}"
        pool = self._pools.get(key)
        if pool is None:
            addr = self.decode_addr if decode else self.query_addr
            if addr is None:
                raise ValueError(
                    "decode workload needs a stateful endpoint "
                    "(decode_addr / --connect-decode)")
            pool = self._pools[key] = _ConnPool(addr,
                                               self.request_timeout_s)
        return pool

    # -- schedules -----------------------------------------------------------

    def schedule(self, replay: Optional[List[dict]] = None
                 ) -> List[Tuple[float, int, int]]:
        """Merged, sorted ``(t_s, tenant_idx, seq)`` arrival plan —
        generated before the clock starts, which is what makes the loop
        open."""
        plan: List[Tuple[float, int, int]] = []
        if replay is not None:
            by_name = {t["name"]: i for i, t in enumerate(self.tenants)}
            for seq, e in enumerate(replay):
                idx = by_name.get(str(e.get("tenant", "")))
                if idx is None:
                    continue
                plan.append((float(e["t"]), idx, seq))
        else:
            for idx, t in enumerate(self.tenants):
                seed = zlib.crc32(
                    f"{self.seed}:{t['name']}".encode()) & 0x7FFFFFFF
                for seq, at in enumerate(
                        gen_arrivals(t["profile"], self.duration_s, seed)):
                    plan.append((at, idx, seq))
        plan.sort()
        return plan

    # -- execution -----------------------------------------------------------

    def _record(self, **kv) -> None:
        with self._rec_lock:
            self.records.append(kv)

    def _roundtrip(self, sock, tensors, tenant: str, pts: int = 0
                   ) -> Tuple[int, tuple]:
        """One traced request round trip; returns ``(trace_id, outs)``."""
        if _spans.enabled:
            tid = _spans.new_trace_id()
            tok = _spans.span_begin(tid, 0)
            try:
                send_tensors(sock, tensors, pts, trace=(tid, tok[0]),
                             tenant=tenant)
                outs, _, _, _ = recv_tensors_ex(sock)
                # observe while the rtt span is still current so the
                # histogram exemplar is stamped with this trace id
                self._observe_latency(
                    tenant, (_spans.now_ns() - tok[1]) / 1e6)
            finally:
                _spans.span_end(tok, "nnsq_rtt", "query",
                                args={"tenant": tenant})
        else:
            tid = zlib.crc32(os.urandom(8))
            t0 = _spans.now_ns()
            send_tensors(sock, tensors, pts, trace=(tid, 0), tenant=tenant)
            outs, _, _, _ = recv_tensors_ex(sock)
            self._observe_latency(tenant, (_spans.now_ns() - t0) / 1e6)
        return tid, outs

    def _observe_latency(self, tenant: str, ms: float) -> None:
        if self._lat_hist is not None:
            self._lat_hist.labels(pipeline=self.metric_pipeline,
                                  src=tenant, sink="client").observe(ms)

    def _run_query(self, tenant: dict, wl: Workload, t_sched_ns: int,
                   seq: int) -> None:
        name = tenant["name"]
        pool = self._pool(name, decode=False)
        t_start = _spans.now_ns()
        tids: List[int] = []
        replies: List[tuple] = []
        status, code = "ok", ""
        sock = None
        try:
            sock = pool.get()
            for tensors in wl.frames(seq):
                tid, outs = self._roundtrip(sock, tensors, name)
                tids.append(tid)
                if self.keep_replies:
                    replies.append(outs)
            pool.put(sock)
        except QueryError as exc:
            # typed rejection: the error frame was fully consumed, the
            # connection stays usable
            status, code = "typed", type(exc).code or "ERROR"
            if sock is not None:
                if code == "TIMEOUT":
                    pool.drop(sock)
                    status = "transport"
                else:
                    pool.put(sock)
        except (ConnectionError, OSError) as exc:
            status, code = "transport", type(exc).__name__
            if sock is not None:
                pool.drop(sock)
        extra = dict(seq=seq, replies=replies) if self.keep_replies else {}
        self._record(tenant=name, workload=wl.name, op="query",
                     trace_ids=tids, t_sched_ns=t_sched_ns,
                     t_start_ns=t_start, t_done_ns=_spans.now_ns(),
                     status=status, code=code, **extra)

    def _run_decode(self, tenant: dict, wl: Workload, t_sched_ns: int,
                    seq: int, d_in: int) -> None:
        """One decode session: prefill prompt, a burst of back-to-back
        steps, then paced steps.  Every frame is its own record (own
        trace id) so the report sees per-step tails, not session means.
        Every record carries the session id (``sid``), so the report can
        tell a session that completed every step — including one that
        was live-migrated under a drain — from one that broke."""
        name = tenant["name"]
        sid = f"{name}/{seq}"
        sock = None
        try:
            sock = socket.create_connection(
                self.decode_addr, timeout=self.request_timeout_s)
            sock.settimeout(self.request_timeout_s)
            frames: List[Tuple[str, np.ndarray]] = [
                ("prefill",
                 np.full((wl.prompt_len, d_in), 0.1, np.float32))]
            frames += [("step", np.full((d_in,), 0.2, np.float32))
                       for _ in range(wl.burst + wl.steps)]
            for i, (op, arr) in enumerate(frames):
                # paced tail: the burst (prefill + first `burst` steps)
                # goes back-to-back, the rest at gap_ms
                if i > wl.burst:
                    time.sleep(wl.gap_ms / 1e3)
                t_s = _spans.now_ns() if i else t_sched_ns
                status, code, tid = "ok", "", 0
                try:
                    tid, _ = self._roundtrip(sock, (arr,), name)
                except QueryError as exc:
                    status, code = "typed", type(exc).code or "ERROR"
                except (ConnectionError, OSError) as exc:
                    status, code = "transport", type(exc).__name__
                self._record(tenant=name, workload=wl.name, op=op,
                             sid=sid, trace_ids=[tid] if tid else [],
                             t_sched_ns=t_s, t_start_ns=t_s,
                             t_done_ns=_spans.now_ns(),
                             status=status, code=code)
                if status != "ok":
                    return
        except (ConnectionError, OSError) as exc:
            self._record(tenant=name, workload=wl.name, op="session",
                         sid=sid, trace_ids=[], t_sched_ns=t_sched_ns,
                         t_start_ns=t_sched_ns, t_done_ns=_spans.now_ns(),
                         status="transport", code=type(exc).__name__)
        finally:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def run(self, replay: Optional[List[dict]] = None,
            d_in: int = 8,
            workloads: Optional[Dict[str, Workload]] = None) -> List[dict]:
        """Drive the plan; ``workloads`` (tenant name -> :class:`Workload`)
        overrides the tenants' named ones from :data:`WORKLOADS`."""
        plan = self.schedule(replay)
        workloads = dict(workloads or {})
        for t in self.tenants:
            if t["name"] not in workloads:
                workloads[t["name"]] = WORKLOADS[t["workload"]]()
        self.t0_ns = t0 = _spans.now_ns()
        with ThreadPoolExecutor(max_workers=self.max_workers) as ex:
            futures = []
            for at, idx, seq in plan:
                # open loop: sleep to the scheduled arrival, then launch
                # regardless of how many requests are still in flight
                delay = at - (_spans.now_ns() - t0) / 1e9
                if delay > 0:
                    time.sleep(delay)
                tenant = self.tenants[idx]
                wl = workloads[tenant["name"]]
                t_sched = t0 + int(at * 1e9)
                if wl.kind == "decode":
                    futures.append(ex.submit(
                        self._run_decode, tenant, wl, t_sched, seq, d_in))
                else:
                    futures.append(ex.submit(
                        self._run_query, tenant, wl, t_sched, seq))
            for f in futures:
                f.result()
        for pool in self._pools.values():
            pool.close_all()
        return self.records


# -- in-process fleet (scenarios / CI gate) ----------------------------------

def _affine_model(sleep_ms: float = 0.0):
    def fn(x):
        if sleep_ms:
            time.sleep(sleep_ms / 1e3)
        return x.to(torch.float32) * 2.0 + 1.0

    return fn


def _torch_model(name: str, device="cuda"):
    """Tiny builds of the served model zoo (the JAX package's scenario
    sizes), on ``device``."""
    if name == "vit":
        from ..models import vit

        # batch=1: serving requests carry a leading batch dim, and the
        # torch backend pins the stream spec to the model's input_spec
        return vit.build(num_classes=8, image_size=32, patch=8,
                         d_model=32, n_heads=2, n_layers=1, batch=1,
                         device=device)
    if name == "audio_cnn":
        from ..models import audio_cnn

        return audio_cnn.build(num_classes=8, window=512,
                               channels=(8, 8), device=device)
    if name == "text_classifier":
        from ..models import text_classifier

        return text_classifier.build(num_classes=4, seq_len=64,
                                     d_model=32, n_heads=2, n_layers=1,
                                     batch=1, device=device)
    raise ValueError(f"unknown model {name!r}")


def build_model(spec, args: Optional[dict] = None, device="cuda"):
    if callable(spec):
        return spec
    if spec == "affine":
        return _affine_model(**(args or {}))
    return _torch_model(spec, device=device)


class InProcFleet:
    """N FleetWorkers + Membership + Router(s) inside this process —
    deterministic (no subprocess scheduling jitter), one shared flight
    recorder (a single local collector source covers every hop).

    ``cfg["autoscale"]`` (a dict of :class:`nnstreamer_tpu_torch.fleet.
    Autoscaler` kwargs, e.g. ``{"min_workers": 1, "max_workers": 3,
    "worker_rps": 40}``) puts the fleet under the SLO-driven autoscaler:
    the initial ``workers`` are adopted by a supervisor, scale-ups spawn
    more in-process workers, scale-downs SIGTERM-drain them
    (migrate-first on the decode surface), and the report grows
    ``scale_events`` + the observed fleet-size range."""

    def __init__(self, cfg: dict, prefix: str = "lg", device="cuda"):
        from ..fleet import FleetWorker, Membership, Router
        from ..sched import AdmissionController, Scheduler

        def make_sched(sc: Optional[dict], name: str):
            if not sc:
                return None
            admission = None
            if any(k in sc for k in ("rate", "max_queue", "deadline_ms")):
                admission = AdmissionController(
                    max_queue=int(sc.get("max_queue", 256)),
                    rate=float(sc.get("rate", 0.0)),
                    burst=float(sc.get("burst", 0.0)),
                    deadline_ms=float(sc.get("deadline_ms", 0.0)))
            return Scheduler(sc.get("policy", "fifo"), admission=admission,
                            name=name,
                            quantum=float(sc.get("quantum", 8.0)))

        self._scheds: List = []
        self.workers = []
        self.prefix = prefix
        wcfg = dict(cfg.get("worker", {}))
        wcfg["device"] = device
        model = build_model(wcfg.pop("model", "affine"),
                            cfg.get("model_args"), device=device)
        self.membership = Membership(heartbeat_s=30.0)
        self.decode_membership = None
        decode_cfg = cfg.get("decode")
        autoscaled = bool(cfg.get("autoscale"))
        for i in range(int(cfg.get("workers", 2))):
            name = f"{prefix}-w{i}"
            wsched = make_sched(cfg.get("worker_sched"), name)
            if wsched is not None:
                self._scheds.append(wsched)
            w = FleetWorker(
                name=name, model=model, scheduler=wsched,
                engine=dict(decode_cfg) if decode_cfg else None,
                decode_port=0 if decode_cfg else None, **wcfg).start()
            self.workers.append(w)
            if not autoscaled:
                # supervised fleets register through Supervisor.adopt
                # below (one id across every surface membership)
                self.membership.add("127.0.0.1", w.query_port,
                                    probe=w.probe, worker_id=name)
        self.membership.sweep()
        self.membership.start()
        rsched = make_sched(cfg.get("router_sched"), f"{prefix}-router")
        if rsched is not None:
            self._scheds.append(rsched)
        self.router = Router(self.membership, port=0, scheduler=rsched,
                             name=f"{prefix}-router").start()
        self.decode_router = None
        if decode_cfg:
            self.decode_membership = Membership(heartbeat_s=30.0)
            if not autoscaled:
                for w in self.workers:
                    self.decode_membership.add(
                        "127.0.0.1", w.decode_port, probe=w.probe,
                        worker_id=f"{w.name}:decode")
            self.decode_membership.sweep()
            self.decode_membership.start()
            self.decode_router = Router(
                self.decode_membership, port=0, stateful=True,
                name=f"{prefix}-drouter").start()
        self.supervisor = None
        self.autoscaler = None
        self.t0_mono = time.monotonic()
        asc_cfg = cfg.get("autoscale")
        if asc_cfg:
            from ..fleet import (
                Autoscaler,
                InProcWorkerFactory,
                RouterSignals,
                Supervisor,
                Surface,
            )
            from ..fleet.supervisor import InProcWorkerHandle

            factory = InProcWorkerFactory(
                model=model, engine=dict(decode_cfg) if decode_cfg else None,
                **wcfg)
            surfaces = [Surface(self.membership, self.router,
                                port_key="port", name="query")]
            if self.decode_router is not None:
                surfaces.append(Surface(
                    self.decode_membership, self.decode_router,
                    port_key="decode_port", name="decode"))
            self.supervisor = Supervisor(
                factory, surfaces, name=f"{prefix}-scale",
                **{k: v for k, v in dict(asc_cfg).items()
                   if k in ("crash_limit", "crash_window_s", "quarantine_s",
                            "respawn_backoff_ms", "respawn_backoff_cap_ms",
                            "spawn_timeout_s", "drain_deadline_s")})
            # the initial workers join the supervised roster: adopt
            # registers each one with EVERY surface membership under one
            # id, so a scale-down drain finds all its surfaces
            for w in self.workers:
                self.supervisor.adopt(w.name, InProcWorkerHandle(w))
            self.autoscaler = Autoscaler(
                self.supervisor, RouterSignals(self.router, self.membership),
                name=f"{prefix}-scale",
                **{k: v for k, v in dict(asc_cfg).items()
                   if k not in ("crash_limit", "crash_window_s",
                                "quarantine_s", "respawn_backoff_ms",
                                "respawn_backoff_cap_ms", "spawn_timeout_s",
                                "drain_deadline_s")}).start()

    @property
    def query_addr(self) -> Tuple[str, int]:
        return ("127.0.0.1", self.router.port)

    @property
    def decode_addr(self) -> Optional[Tuple[str, int]]:
        if self.decode_router is None:
            return None
        return ("127.0.0.1", self.decode_router.port)

    def stats(self) -> dict:
        out = {"router": self.router.stats(),
               "workers": {w.name: w.stats() for w in self.workers}}
        if self.decode_router is not None:
            out["decode_router"] = self.decode_router.stats()
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.stats()
            out["autoscaler"]["t0_mono"] = self.t0_mono
        return out

    def close(self) -> None:
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        for router in (self.router, self.decode_router):
            if router is not None:
                router.stop()
        for m in (self.membership, self.decode_membership):
            if m is not None:
                m.stop()
        for w in self.workers:
            try:
                w.stop()
            except Exception:  # noqa: BLE001
                pass
        for s in self._scheds:
            s.close()


# -- report ------------------------------------------------------------------

def _latency_ns(rec: dict) -> int:
    return max(0, rec["t_done_ns"] - rec["t_sched_ns"])


def build_report(records: List[dict], duration_s: float, t0_ns: int,
                 tenants_cfg: List[dict], seed: int, scenario: str = "",
                 server_stats: Optional[dict] = None,
                 collector: Optional[TraceCollector] = None,
                 windows: int = 6,
                 forensics_engine=None) -> dict:
    """The machine-readable artifact: per-tenant SLO stats, p50/p99/p99.9
    vs offered load, the exact ledger, and per-trace latency attribution
    joined via NNSQ trace ids."""
    well_behaved = {t["name"]: bool(t.get("well_behaved", True))
                    for t in tenants_cfg}
    by_tenant: Dict[str, List[dict]] = {}
    for r in records:
        by_tenant.setdefault(r["tenant"], []).append(r)

    tenants = {}
    for name, recs in sorted(by_tenant.items()):
        ok = [r for r in recs if r["status"] == "ok"]
        typed: Dict[str, int] = {}
        for r in recs:
            if r["status"] == "typed":
                typed[r["code"]] = typed.get(r["code"], 0) + 1
        transport = sum(1 for r in recs if r["status"] == "transport")
        span_s = max(duration_s, 1e-9)
        tenants[name] = {
            "well_behaved": well_behaved.get(name, True),
            "workload": recs[0]["workload"],
            "offered": len(recs),
            "ok": len(ok),
            "typed": typed,
            "typed_total": sum(typed.values()),
            "transport": transport,
            "offered_rps": len(recs) / span_s,
            "goodput_rps": len(ok) / span_s,
            "latency_ms": summarize_ms([_latency_ns(r) for r in ok]),
        }

    # p50/p99/p99.9 vs offered load: windowed over the run, so ramp /
    # spike / diurnal profiles trace out the latency-vs-load curve
    curves = []
    w_ns = int(duration_s * 1e9 / max(1, windows))
    for i in range(max(1, windows)):
        lo, hi = t0_ns + i * w_ns, t0_ns + (i + 1) * w_ns
        win = [r for r in records if lo <= r["t_sched_ns"] < hi]
        ok = [r for r in win if r["status"] == "ok"]
        lat = summarize_ms([_latency_ns(r) for r in ok])
        curves.append({
            "t0_s": i * w_ns / 1e9,
            "t1_s": (i + 1) * w_ns / 1e9,
            "offered_rps": len(win) / (w_ns / 1e9),
            "goodput_rps": len(ok) / (w_ns / 1e9),
            "p50_ms": lat.get("p50_ms", 0.0),
            "p99_ms": lat.get("p99_ms", 0.0),
            "p999_ms": lat.get("p999_ms", 0.0),
        })

    # exact ledger: every scheduled request must be accounted for —
    # delivered, typed-shed, or a (counted) transport failure — on BOTH
    # sides of the wire.  Client round trips (a cascade record is 2 wire
    # requests; trace_ids holds the DELIVERED legs) must reconcile with
    # the router's offered == delivered + shed counts exactly.
    client = {
        "sent": len(records),
        "ok": sum(1 for r in records if r["status"] == "ok"),
        "typed": sum(1 for r in records if r["status"] == "typed"),
        "transport": sum(1 for r in records
                         if r["status"] == "transport"),
    }
    ledger = {"client": client,
              "client_exact": client["sent"] == client["ok"]
              + client["typed"] + client["transport"]}
    if server_stats is not None:
        rt = server_stats.get("router", {})
        shed_total = rt.get("shed_total", 0)
        ledger["router"] = {
            "offered": rt.get("offered", 0),
            "delivered": rt.get("delivered", 0),
            "shed": rt.get("shed", {}),
            "shed_total": shed_total,
            "tenants": rt.get("tenants", {}),
        }
        ledger["router_exact"] = (
            rt.get("offered", 0)
            == rt.get("delivered", 0) + shed_total)
        # decode traffic rides a different router; only the stateless
        # round trips are cross-checked client-vs-router
        delivered_rt = sum(len(r["trace_ids"]) for r in records
                           if r["op"] == "query")
        typed_rt = sum(1 for r in records
                       if r["status"] == "typed" and r["op"] == "query")
        ledger["client_roundtrips"] = {
            "delivered": delivered_rt, "typed": typed_rt}
        has_decode = any(r["op"] != "query" for r in records)
        ledger["exact"] = bool(
            ledger["client_exact"] and ledger["router_exact"]
            and (has_decode or (
                delivered_rt == rt.get("delivered", 0)
                and typed_rt == shed_total)))
    else:
        ledger["exact"] = ledger["client_exact"]

    # stateful-session accounting: a decode session either COMPLETED
    # every step (possibly live-migrated mid-stream — invisible to the
    # client, counted from the router's handoff ledger), was SHED typed
    # at the join, or BROKE mid-stream ([SESSION]/transport) — the
    # distinction the drain SLO gate needs to require 100% stateful
    # goodput through a planned drain
    sessions: Dict[str, str] = {}
    for r in records:
        sid = r.get("sid")
        if not sid:
            continue
        verdict = sessions.get(sid, "completed")
        if verdict == "completed" and r["status"] != "ok":
            if r["status"] == "transport" or r.get("code") in (
                    "SESSION", "MIGRATING", "TIMEOUT"):
                verdict = "broken"
            else:
                verdict = "shed"  # typed join rejection (overload etc.)
        sessions[sid] = verdict
    decode_sessions: dict = {}
    if sessions:
        decode_sessions = {
            "total": len(sessions),
            "completed": sum(1 for v in sessions.values()
                             if v == "completed"),
            "broken": sum(1 for v in sessions.values() if v == "broken"),
            "shed": sum(1 for v in sessions.values() if v == "shed"),
        }
        drt = (server_stats or {}).get("decode_router", {})
        decode_sessions["migrated"] = drt.get("sessions_migrated", 0)
        decode_sessions["migration_aborts"] = drt.get(
            "migration_aborts", {})

    # elastic-fleet accounting: the autoscaler's scale events (spawn /
    # drain / quarantine ... with run-relative timestamps) and the
    # observed fleet-size range, so p99-vs-fleet-size reads off one
    # report — the same instants land on the --perfetto timeline as
    # scale:<action> markers when spans were on
    scale_events: List[dict] = []
    fleet_range: dict = {}
    asc = (server_stats or {}).get("autoscaler")
    if asc:
        t0_mono = asc.get("t0_mono")
        for e in asc.get("events", []):
            rec = {"action": e["action"], "worker": e["worker"],
                   "detail": e["detail"]}
            if t0_mono is not None:
                rec["t_s"] = round(e["t"] - t0_mono, 6)
            if "fleet" in e:
                rec["fleet"] = e["fleet"]
            scale_events.append(rec)
        fleet_range = {
            "min": asc.get("fleet_size_min"),
            "max": asc.get("fleet_size_max"),
            "final": asc.get("workers"),
            "quarantined": asc.get("supervisor", {}).get("quarantined"),
            "spawn_ledger_exact": asc.get("ledger_exact"),
        }

    # per-trace attribution: join client records with collected server
    # spans by NNSQ trace id
    attribution: dict = {"joined": 0, "client_only": 0, "server_only": 0}
    if collector is not None:
        collected = collector.collect()
        index = collector.spans_by_trace(collected)
        client_tids = set()
        legs_acc: Dict[str, List[float]] = {}
        per_trace = []
        for r in records:
            if r["status"] != "ok" or not r["trace_ids"]:
                continue
            legs: Dict[str, float] = {}
            hit = False
            for tid in r["trace_ids"]:
                client_tids.add(tid)
                recs = index.get(tid)
                if recs:
                    hit = True
                    tlegs = attribute_trace(recs)
                    for k, v in tlegs.items():
                        legs[k] = legs.get(k, 0.0) + v
                    if forensics_engine is not None:
                        forensics_engine.score_trace(
                            tid, int(tlegs.get("rtt") or _latency_ns(r)),
                            records=recs)
            if not hit:
                attribution["client_only"] += 1
                continue
            attribution["joined"] += 1
            total = _latency_ns(r)
            legs["client_total"] = float(total)
            if legs.get("rtt"):
                # client-side queueing: scheduled-arrival to first byte
                legs["client_queue"] = max(0.0, total - legs["rtt"])
            for k, v in legs.items():
                legs_acc.setdefault(k, []).append(v)
            if len(per_trace) < 32:  # a sample for eyeballing
                per_trace.append(
                    {"tenant": r["tenant"], "workload": r["workload"],
                     "trace_ids": [f"{t:x}" for t in r["trace_ids"]],
                     **{k: v / 1e6 for k, v in legs.items()}})
        # server spans whose client record was dropped (open-loop
        # clients can crash/timeout; the trace must still be explainable)
        attribution["server_only"] = sum(
            1 for tid in index if tid not in client_tids)
        attribution["legs_ms"] = {
            k: {"mean_ms": sum(v) / len(v) / 1e6,
                "p99_ms": pct(sorted(v), 0.99) / 1e6}
            for k, v in sorted(legs_acc.items())}
        # explicitly-unknown residual (client RTT not covered by any
        # joined server envelope — see attribute_trace): surfaced on
        # its own so a report reader cannot mistake it for wire time
        unattr = legs_acc.get("unattributed")
        if unattr:
            attribution["unattributed_us"] = round(
                sum(unattr) / len(unattr) / 1e3, 3)
        attribution["sample"] = per_trace
        attribution["collector_errors"] = collected["errors"]

    return {
        "kind": "loadgen_report",
        "scenario": scenario,
        "seed": seed,
        "duration_s": duration_s,
        "generated_unix": time.time(),
        "tenants": tenants,
        "curves": curves,
        "ledger": ledger,
        "decode_sessions": decode_sessions,
        "scale_events": scale_events,
        "fleet": fleet_range,
        "attribution": attribution,
        "forensics": (forensics_engine.summary()
                      if forensics_engine is not None else {}),
        "server": server_stats or {},
    }


# -- SLO gate ----------------------------------------------------------------

def check_slo(report: dict, slo: dict) -> Tuple[bool, List[dict]]:
    """Evaluate a scenario's SLO spec against its report.  Checks:

    - ``well_behaved_p99_ms``: every well-behaved tenant's p99 ≤ bound;
    - ``well_behaved_goodput_min``: ok/offered ratio per well-behaved
      tenant ≥ bound (typed sheds of polite traffic are SLO violations);
    - ``flood_shed_min``: the flooding tenant really was shed (the
      overload scenario must actually overload);
    - ``ledger_exact``: zero lost/unaccounted requests on both sides;
    - ``max_transport_errors``: transport failures ≤ bound;
    - ``stateful_goodput_min``: completed/total decode sessions ≥ bound
      (migrated sessions count as completed — the drain gate sets 1.0);
    - ``max_broken_sessions``: sessions broken ``[SESSION]``/torn ≤
      bound;
    - ``max_fleet``: the autoscaled fleet actually scaled UP — its peak
      observed size ≥ bound;
    - ``min_fleet``: ...and back DOWN — its size at run end ≤ bound
      (the diurnal elasticity gate asserts both, plus the exact spawn
      ledger whenever either key is present).
    """
    checks: List[dict] = []

    def add(name, ok, value, bound):
        checks.append({"check": name, "ok": bool(ok), "value": value,
                       "bound": bound})

    tenants = report["tenants"]
    wb = {n: t for n, t in tenants.items() if t["well_behaved"]}
    flood = {n: t for n, t in tenants.items() if not t["well_behaved"]}
    if "well_behaved_p99_ms" in slo:
        bound = float(slo["well_behaved_p99_ms"])
        for n, t in sorted(wb.items()):
            p99 = t["latency_ms"].get("p99_ms", float("inf")) \
                if t["ok"] else float("inf")
            add(f"p99[{n}] <= {bound}ms", p99 <= bound, p99, bound)
    if "well_behaved_goodput_min" in slo:
        bound = float(slo["well_behaved_goodput_min"])
        for n, t in sorted(wb.items()):
            ratio = t["ok"] / t["offered"] if t["offered"] else 0.0
            add(f"goodput[{n}] >= {bound}", ratio >= bound, ratio, bound)
    if "flood_shed_min" in slo:
        bound = int(slo["flood_shed_min"])
        shed = sum(t["typed_total"] for t in flood.values())
        add(f"flood_typed_shed >= {bound}", shed >= bound, shed, bound)
    if slo.get("ledger_exact"):
        add("ledger_exact", report["ledger"]["exact"],
            report["ledger"], True)
    if "max_transport_errors" in slo:
        bound = int(slo["max_transport_errors"])
        n = report["ledger"]["client"]["transport"]
        add(f"transport_errors <= {bound}", n <= bound, n, bound)
    ds = report.get("decode_sessions") or {}
    if "stateful_goodput_min" in slo:
        # 100% here through a drain is the live-migration promise: every
        # session completes, none break [SESSION]
        bound = float(slo["stateful_goodput_min"])
        ratio = (ds.get("completed", 0) / ds["total"]) if ds.get("total") \
            else 0.0
        add(f"stateful_goodput >= {bound}", ratio >= bound, ratio, bound)
    if "max_broken_sessions" in slo:
        bound = int(slo["max_broken_sessions"])
        n = ds.get("broken", 0)
        add(f"broken_sessions <= {bound}", n <= bound, n, bound)
    fleet = report.get("fleet") or {}
    if "max_fleet" in slo:
        bound = int(slo["max_fleet"])
        peak = fleet.get("max") or 0
        add(f"fleet_peak >= {bound}", peak >= bound, peak, bound)
    if "min_fleet" in slo:
        bound = int(slo["min_fleet"])
        final = fleet.get("final")
        add(f"fleet_final <= {bound}",
            final is not None and final <= bound, final, bound)
    if ("max_fleet" in slo or "min_fleet" in slo):
        # elasticity implies the spawn ledger must balance exactly
        add("spawn_ledger_exact", bool(fleet.get("spawn_ledger_exact")),
            fleet.get("spawn_ledger_exact"), True)
    ok = all(c["ok"] for c in checks)
    return ok, checks


# -- scenario matrix ---------------------------------------------------------

SCENARIOS: Dict[str, dict] = {
    "ci-slo": dict(
        description="CI SLO gate: seeded Poisson, in-process 2-worker "
                    "fleet, 1 flooding tenant vs 3 well-behaved — DRR + "
                    "per-tenant rate admission must hold the polite p99 "
                    "and the ledger must balance exactly",
        duration_s=3.0,
        fleet=dict(
            workers=2,
            worker=dict(framework="custom", batch=4, batch_window_ms=2.0,
                        max_batch=32),
            model_args={"sleep_ms": 0.3},
            worker_sched=dict(policy="drr", max_queue=512),
            router_sched=dict(policy="drr", rate=60.0, burst=20.0,
                              max_queue=256),
        ),
        tenants=[
            dict(name="flood", workload="vision", well_behaved=False,
                 profile=dict(kind="constant", rate=220.0)),
            dict(name="tenant-a", workload="vision",
                 profile=dict(kind="constant", rate=14.0)),
            dict(name="tenant-b", workload="lstm_window",
                 profile=dict(kind="constant", rate=11.0)),
            dict(name="tenant-c", workload="ssd_cascade",
                 profile=dict(kind="constant", rate=7.0)),
        ],
        slo=dict(well_behaved_p99_ms=1500.0,
                 well_behaved_goodput_min=0.95,
                 flood_shed_min=10,
                 ledger_exact=True,
                 max_transport_errors=0),
    ),
    "mix": dict(
        description="multi-workload ramp: vision + cascade + LSTM "
                    "tenants ramping 5→40 rps each (the latency-vs-load "
                    "curve scenario)",
        duration_s=6.0,
        fleet=dict(
            workers=2,
            worker=dict(framework="custom", batch=4, batch_window_ms=2.0,
                        max_batch=32),
            model_args={"sleep_ms": 0.5},
            worker_sched=dict(policy="drr", max_queue=512),
        ),
        tenants=[
            dict(name="cam", workload="vision",
                 profile=dict(kind="ramp", lo=5.0, hi=40.0)),
            dict(name="detector", workload="ssd_cascade",
                 profile=dict(kind="ramp", lo=5.0, hi=40.0)),
            dict(name="sensors", workload="lstm_window",
                 profile=dict(kind="ramp", lo=5.0, hi=40.0)),
        ],
    ),
    "spike": dict(
        description="flash-crowd spike: steady vision load with a 6x "
                    "spike window mid-run",
        duration_s=5.0,
        fleet=dict(
            workers=2,
            worker=dict(framework="custom", batch=4, batch_window_ms=2.0,
                        max_batch=32),
            model_args={"sleep_ms": 0.5},
        ),
        tenants=[
            dict(name="steady", workload="vision",
                 profile=dict(kind="spike", rate=20.0, peak=120.0,
                              at=0.5, width=0.2)),
        ],
    ),
    "diurnal": dict(
        description="diurnal cycles compressed into the run (two "
                    "day/night periods)",
        duration_s=6.0,
        fleet=dict(
            workers=2,
            worker=dict(framework="custom", batch=4, batch_window_ms=2.0,
                        max_batch=32),
            model_args={"sleep_ms": 0.5},
        ),
        tenants=[
            dict(name="daynight", workload="vision",
                 profile=dict(kind="diurnal", rate=30.0, amp=0.8,
                              periods=2)),
        ],
    ),
    "diurnal-scale": dict(
        description="elastic diurnal cycle under the SLO-driven "
                    "autoscaler: the fleet scales up ahead of the peak "
                    "(forecast leg) and SIGTERM-drains back down on the "
                    "night slope — scale_events + fleet range in the "
                    "report, min_fleet/max_fleet SLO keys gated",
        duration_s=9.0,
        fleet=dict(
            workers=1,
            worker=dict(framework="custom", batch=4, batch_window_ms=2.0,
                        max_batch=32),
            model_args={"sleep_ms": 0.5},
            autoscale=dict(min_workers=1, max_workers=3, worker_rps=18.0,
                           interval_s=0.25, up_cooldown_s=0.5,
                           down_cooldown_s=1.0, forecast=True,
                           forecast_horizon_s=1.5, history_window_s=3.0,
                           queue_wait_lo_ms=30.0, storm_budget=6,
                           storm_window_s=30.0),
        ),
        tenants=[
            dict(name="daynight", workload="vision",
                 profile=dict(kind="diurnal", rate=28.0, amp=0.9,
                              periods=1)),
        ],
        slo=dict(ledger_exact=True,
                 max_transport_errors=0,
                 max_fleet=2,     # the peak really staffed up
                 min_fleet=2),    # ...and the night slope drained back
    ),
    # the model zoo's served scenarios: tiny builds of the real models
    # behind the same fleet path
    "vit": dict(
        description="ViT classifier serving: single-shot 32x32 images "
                    "against a 2-worker fleet",
        duration_s=4.0,
        fleet=dict(workers=2,
                   worker=dict(framework="torch", model="vit")),
        tenants=[
            dict(name="vit-cam", workload="vit",
                 profile=dict(kind="constant", rate=12.0)),
        ],
    ),
    "audio_cnn": dict(
        description="keyword-spotting serving: aggregator windows "
                    "against the audio_cnn fleet",
        duration_s=4.0,
        fleet=dict(workers=2,
                   worker=dict(framework="torch", model="audio_cnn")),
        tenants=[
            dict(name="mic", workload="audio_cnn",
                 profile=dict(kind="constant", rate=12.0)),
        ],
    ),
    "text_classifier": dict(
        description="byte-level text classification serving: uint8 "
                    "text buffers against the text_classifier fleet",
        duration_s=4.0,
        fleet=dict(workers=2,
                   worker=dict(framework="torch",
                               model="text_classifier")),
        tenants=[
            dict(name="ingest", workload="text_classifier",
                 profile=dict(kind="constant", rate=12.0)),
        ],
    ),
    "decode": dict(
        description="continuous-batch decode with prefill bursts: "
                    "stateful sessions pinned through the fleet router",
        duration_s=4.0,
        fleet=dict(
            workers=2,
            worker=dict(framework="custom"),
            decode=dict(capacity=4, t_max=32, d_in=8, n_out=4,
                        d_model=16, n_heads=2, n_layers=1),
        ),
        tenants=[
            dict(name="chat", workload="decode",
                 profile=dict(kind="constant", rate=3.0)),
        ],
    ),
}


def _warm(fleet: "InProcFleet", tenants: List[dict], d_in: int) -> None:
    """One synchronous request per workload against EVERY worker before
    the clock starts: first-capture time (model scenarios) and per-spec
    backend construction never pollute the curves, and warming directly
    (bypassing the router) keeps the router ledger exactly equal to the
    measured run's traffic."""
    for t in tenants:
        wl = WORKLOADS[t["workload"]]()
        for w in fleet.workers:
            try:
                if wl.kind == "decode":
                    sock = socket.create_connection(
                        ("127.0.0.1", w.decode_port), timeout=60)
                    sock.settimeout(60.0)
                    send_tensors(sock, (np.full((wl.prompt_len, d_in), 0.1,
                                                np.float32),), 0)
                    recv_tensors_ex(sock)
                    send_tensors(sock, (np.full((d_in,), 0.1,
                                                np.float32),), 0)
                    recv_tensors_ex(sock)
                    sock.close()
                else:
                    sock = socket.create_connection(
                        ("127.0.0.1", w.query_port), timeout=120)
                    sock.settimeout(120.0)
                    for tensors in wl.frames(0):
                        send_tensors(sock, tensors, 0)
                        recv_tensors_ex(sock)
                    sock.close()
            except (RuntimeError, ConnectionError, OSError):
                pass  # warmup is best-effort (an admission-limited
                #       worker may shed it; the run proper still measures)


def settle_router(router, timeout_s: float = 10.0) -> bool:
    """Wait (up to ``timeout_s``) until ``router``'s ledger balances,
    offered == delivered + shed: the router counts a delivery just after
    the reply bytes go out, so a snapshot taken the moment the last client
    reply lands can hold one request offered and not yet delivered."""
    deadline = time.monotonic() + timeout_s
    while True:
        st = router.stats()
        if st["offered"] == st["delivered"] + st["shed_total"]:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.005)


def run_scenario(name: str, seed: int = 7,
                 duration_s: Optional[float] = None,
                 windows: int = 6, max_workers: int = 64,
                 warm: bool = True, device="cuda") -> dict:
    """Run one scenario against a fresh in-process fleet on ``device``;
    returns the report (the fleet is torn down before returning)."""
    sc = SCENARIOS[name]
    duration = float(duration_s if duration_s is not None
                     else sc.get("duration_s", 3.0))
    _spans.enable()
    collector = TraceCollector()
    collector.add_local("loadgen")
    fleet = InProcFleet(sc["fleet"], prefix=f"lg-{name}", device=device)
    d_in = int(sc["fleet"].get("decode", {}).get("d_in", 8) or 8)
    try:
        lg = LoadGen(fleet.query_addr, sc["tenants"], duration,
                     seed=seed, decode_addr=fleet.decode_addr,
                     max_workers=max_workers, metric_pipeline=f"lg-{name}")
        if warm:
            _warm(fleet, sc["tenants"], d_in)
            _spans.clear()  # warmup spans out of the report
        records = lg.run(d_in=d_in)
        for router in (fleet.router, fleet.decode_router):
            if router is not None:
                settle_router(router)
        # tail forensics rides along when a gallery dir is configured:
        # every joined trace is scored against the cost-model baseline
        fengine = None
        if _forensics.configured_dir():
            fengine = _forensics.ForensicsEngine(pipeline=f"lg-{name}")
        report = build_report(
            records, duration, lg.t0_ns, sc["tenants"], seed,
            scenario=name, server_stats=fleet.stats(),
            collector=collector, windows=windows,
            forensics_engine=fengine)
        report["slo_spec"] = sc.get("slo", {})
        if sc.get("slo"):
            ok, checks = check_slo(report, sc["slo"])
            report["slo"] = {"pass": ok, "checks": checks}
        return report
    finally:
        fleet.close()


# -- CLI ---------------------------------------------------------------------

def _print_summary(report: dict) -> None:
    print(f"scenario={report['scenario'] or '(external)'} "
          f"seed={report['seed']} duration={report['duration_s']}s")
    for name, t in report["tenants"].items():
        lat = t["latency_ms"]
        print(f"  tenant {name:<16} {'well-behaved' if t['well_behaved'] else 'FLOOD':<12} "
              f"offered={t['offered']:>5} ok={t['ok']:>5} "
              f"typed={t['typed_total']:>4} transport={t['transport']} "
              f"p50={lat.get('p50_ms', 0):8.2f}ms "
              f"p99={lat.get('p99_ms', 0):8.2f}ms "
              f"p99.9={lat.get('p999_ms', 0):8.2f}ms")
    led = report["ledger"]
    print(f"  ledger exact={led['exact']} client={led['client']}")
    if report.get("fleet"):
        fl = report["fleet"]
        print(f"  fleet: {fl.get('min')} -> {fl.get('max')} -> "
              f"{fl.get('final')} workers, "
              f"spawn ledger exact={fl.get('spawn_ledger_exact')}")
        for e in report.get("scale_events", []):
            t = e.get("t_s")
            print(f"    [{t:8.3f}s] {e['action']:<12} {e['worker']:<14} "
                  f"{e['detail']}" if t is not None else
                  f"    {e['action']:<12} {e['worker']:<14} {e['detail']}")
    attr = report.get("attribution", {})
    if attr.get("joined"):
        print(f"  attribution: {attr['joined']} traces joined, "
              f"{attr['client_only']} client-only, "
              f"{attr['server_only']} server-only")
        for leg, v in attr.get("legs_ms", {}).items():
            print(f"    {leg:<14} mean={v['mean_ms']:8.3f}ms "
                  f"p99={v['p99_ms']:8.3f}ms")
    if "slo" in report:
        print(f"  SLO: {'PASS' if report['slo']['pass'] else 'FAIL'}")
        for c in report["slo"]["checks"]:
            mark = "ok " if c["ok"] else "FAIL"
            print(f"    [{mark}] {c['check']}: value={c['value']} "
                  f"bound={c['bound']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and exit")
    ap.add_argument("--scenario", default="",
                    help="run a named scenario against an in-process fleet")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--windows", type=int, default=6,
                    help="curve resolution (time windows)")
    ap.add_argument("--max-workers", type=int, default=64,
                    help="open-loop client concurrency bound")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where a scenario's in-process fleet serves: the "
                         "card (default) or the host")
    ap.add_argument("--out", default="",
                    help="write the full JSON report here")
    ap.add_argument("--perfetto", default="",
                    help="write the merged cross-process Perfetto trace "
                         "here (scenario mode)")
    ap.add_argument("--assert-slo", action="store_true",
                    help="exit non-zero when the scenario's SLO fails")
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the pre-run warmup request per workload")
    # external-target mode
    ap.add_argument("--connect", default="",
                    help="host:port of an external NNSQ endpoint "
                         "(instead of an in-process fleet)")
    ap.add_argument("--connect-decode", default="",
                    help="host:port of a stateful decode endpoint")
    ap.add_argument("--workload", default="vision",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--tenant", default="loadgen")
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--replay", default="",
                    help="JSON arrival-trace file to replay instead of "
                         "Poisson arrivals")
    ap.add_argument("--trace-source", action="append", default=[],
                    metavar="NAME=HOST:PORT",
                    help="collect /trace.json from this process for "
                         "attribution (repeatable; external mode)")
    args = ap.parse_args(argv)

    if args.list:
        for name, sc in SCENARIOS.items():
            print(f"{name:<18} {sc['description']}")
        return 0

    if args.scenario:
        collector_doc = None
        report = run_scenario(
            args.scenario, seed=args.seed, duration_s=args.duration,
            windows=args.windows, max_workers=args.max_workers,
            warm=not args.no_warm, device=args.device)
        if args.perfetto:
            # the scenario's fleet is gone, but its spans are in this
            # process's recorder — rebuild the merged doc from it
            c = TraceCollector()
            c.add_local("loadgen")
            collector_doc = c.chrome_trace()
            with open(args.perfetto, "w", encoding="utf-8") as fh:
                json.dump(collector_doc, fh)
            print(f"perfetto trace -> {args.perfetto} "
                  f"({len(collector_doc['traceEvents'])} events)")
    else:
        if not args.connect:
            ap.error("pass --scenario NAME or --connect HOST:PORT")
        host, _, port = args.connect.rpartition(":")
        daddr = None
        if args.connect_decode:
            dh, _, dp = args.connect_decode.rpartition(":")
            daddr = (dh or "127.0.0.1", int(dp))
        _spans.enable()
        collector = TraceCollector()
        collector.add_local("loadgen")
        for spec in args.trace_source:
            sname, _, saddr = spec.partition("=")
            collector.add_http(sname, saddr)
        tenants = [dict(name=args.tenant, workload=args.workload,
                        profile=dict(kind="constant", rate=args.rate))]
        replay = load_replay(args.replay) if args.replay else None
        duration = float(args.duration or
                         (replay[-1]["t"] + 1.0 if replay else 5.0))
        lg = LoadGen((host or "127.0.0.1", int(port)), tenants, duration,
                     seed=args.seed, decode_addr=daddr,
                     max_workers=args.max_workers)
        records = lg.run(replay=replay)
        fengine = (_forensics.ForensicsEngine(pipeline="loadgen")
                   if _forensics.configured_dir() else None)
        report = build_report(records, duration, lg.t0_ns, tenants,
                              args.seed, scenario="",
                              collector=collector, windows=args.windows,
                              forensics_engine=fengine)

    _print_summary(report)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, default=str)
        print(f"report -> {args.out}")
    print("LOADGEN_FINAL " + json.dumps({
        "scenario": report["scenario"],
        "ledger_exact": report["ledger"]["exact"],
        "slo_pass": report.get("slo", {}).get("pass"),
        "tenants": {n: {"ok": t["ok"], "offered": t["offered"],
                        "p99_ms": t["latency_ms"].get("p99_ms")}
                    for n, t in report["tenants"].items()},
    }, default=str))
    if args.assert_slo:
        slo = report.get("slo")
        if slo is None:
            print("SLO GATE: no slo spec in this scenario", file=sys.stderr)
            return 2
        return 0 if slo["pass"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
