"""Device *utilization* lane: live MFU and roofline attribution.

The port's copy of the JAX package's ``obs/util.py``.  The device lane
(:mod:`.device`) answers "how long did each dispatch execute"; this module
turns those durations into *efficiency*: was the card busy or idle,
compute-bound or starved for bytes.

- **Per-executable cost registry** — ``backends/torch_backend.py`` calls
  :func:`register_cost` once per captured geometry with its FLOPs (counted
  by ``torch.utils.flop_counter.FlopCounterMode`` over the eager warm-up
  call before the capture) and a lower bound of its bytes (parameters,
  inputs and outputs, each once), keyed by a per-process fingerprint; the
  :class:`~.device.DeviceTracer` reaper looks the key back up per dispatch
  and computes achieved TFLOP/s, achieved GB/s and MFU for the
  ``nnstpu_mfu{device,node,bucket}`` gauge and the ``device_exec`` span
  args.
- **Roofline math** — :func:`roofline` classifies a dispatch by arithmetic
  intensity against the peaks' ridge point (``compute_bound`` /
  ``bandwidth_bound``).  Peaks come from ``NNSTPU_PEAK_TFLOPS`` / ini
  ``[obs] peak_tflops`` (and the ``_gbs`` twins) over a default keyed on
  the card's name (``torch.cuda.get_device_name()``): the published dense
  bfloat16 rate and memory rate of the card at its full power limit.  The
  JAX package's generic ``"gpu"`` row (60 TFLOP/s, 900 GB/s) is not this
  card's and is not copied.  Partial payloads (no FLOPs, bytes only) read
  ``mfu=None`` and ``bound="unknown"``: never an exception.
- **Dead-time accounting** — :func:`merge_intervals`,
  :func:`busy_fraction` and :func:`idle_gaps` compute windowed busy and
  idle coverage from ``device_exec`` intervals; :class:`DeviceUsage` is
  the bounded per-device interval store behind
  ``nnstpu_device_busy_fraction{device}``.
- **Wire health as live metrics** — :func:`probe_wire_health` times 150 KB
  pinned host-to-device copies with CUDA events; :func:`publish_wire_health`
  republishes a probe as ``nnstpu_wire_put_ms`` / ``nnstpu_wire_dispatch_ms``
  / ``nnstpu_wire_regime`` gauges plus a ``wire_health`` stats provider.
  Partition edges publish under their ``host:port`` (:func:`wire_health_by_addr`)
  and register a prober (:func:`register_wire_edge`) that the watchdog runs
  on its wire cadence beside the local probe.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .metrics import REGISTRY, MetricsRegistry

# -- peak configuration -------------------------------------------------------

# Peak compute (TFLOP/s) and memory rate (GB/s) by the card's name
# (torch.cuda.get_device_name()), the denominators of MFU and the ridge
# point: NVIDIA's data sheet, dense bfloat16 without sparsity, at the card's
# full power limit (700 W for the H100 SXM).  A card set below it runs
# slower; the exposition keeps the published peak as the denominator.
PEAKS_BY_DEVICE: Dict[str, Tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
}
# The host row (no card, or a card not listed): the JAX package's
# deliberately round CPU envelope, so a CPU run gives plausible,
# clearly-not-card numbers instead of dividing by a card's peak.
HOST_PEAKS: Tuple[float, float] = (0.5, 40.0)

WIRE_SICK_PUT_MS = 5.0  # >5 ms per 150 KB put: the slow-wire regime


def _default_device_name() -> str:
    """The name of card 0 once this process uses CUDA, else ``"cpu"``
    (a process that never touched the card gets no CUDA context here)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.get_device_name(0)
    return "cpu"


def _peak_from(env_key: str, conf_key: str, index: int,
               device: Optional[str]) -> float:
    import os

    val = os.environ.get(env_key)
    if val in (None, ""):
        from ..conf import conf

        val = conf.get("obs", conf_key, "")
    if val not in (None, ""):
        try:
            peak = float(val)
            if peak > 0:
                return peak
        except ValueError:
            pass  # a malformed override falls through to the default
    name = device or _default_device_name()
    return PEAKS_BY_DEVICE.get(name, HOST_PEAKS)[index]


def peak_tflops(device: Optional[str] = None) -> float:
    """Peak compute in TFLOP/s: ``NNSTPU_PEAK_TFLOPS`` over ini ``[obs]
    peak_tflops`` over the default of the card named ``device`` (default:
    card 0's name)."""
    return _peak_from("NNSTPU_PEAK_TFLOPS", "peak_tflops", 0, device)


def peak_gbs(device: Optional[str] = None) -> float:
    """Peak memory rate in GB/s: ``NNSTPU_PEAK_GBS`` over ini ``[obs]
    peak_gbs`` over the default of the card named ``device``."""
    return _peak_from("NNSTPU_PEAK_GBS", "peak_gbs", 1, device)


# -- per-executable cost registry ---------------------------------------------

_COST_CAP = 256  # executables are LRU-bounded per backend; this bounds all

_cost_lock = threading.Lock()
_costs: "OrderedDict[str, dict]" = OrderedDict()


def register_cost(key: str, flops: Optional[float] = None,
                  bytes: Optional[float] = None, **meta) -> str:
    """Record one captured geometry's cost profile under ``key`` (the
    backend's fingerprint).  ``flops``/``bytes`` may be None or 0 (a
    function of custom kernels alone counts no FLOPs); the entry still
    registers, so every dispatch resolves to *something* and cost-less
    ones show up as ``mfu=None`` instead of vanishing from the efficiency
    view.  Returns ``key``."""
    entry = dict(meta)
    entry["flops"] = float(flops) if flops else None
    entry["bytes"] = float(bytes) if bytes else None
    with _cost_lock:
        _costs[key] = entry
        _costs.move_to_end(key)
        while len(_costs) > _COST_CAP:
            _costs.popitem(last=False)
    return key


def release_hbm(key: str, hbm: Optional[dict]) -> None:
    """The capture that registered ``hbm`` (its memory record) under
    ``key`` is gone, and its graph pool with it: the record leaves the
    entry, and so the memory ledger.  The cost stays, for the spans that
    already read it.  Only that record goes: a live capture that has
    registered the same fingerprint since keeps its own."""
    with _cost_lock:
        entry = _costs.get(key)
        if entry is not None and hbm is not None and entry.get("hbm") is hbm:
            del entry["hbm"]


def cost_of(key: Optional[str]) -> Optional[dict]:
    """The registered cost profile for ``key``, or None."""
    if not key:
        return None
    with _cost_lock:
        entry = _costs.get(key)
        return dict(entry) if entry is not None else None


def clear_costs() -> None:
    """Drop every registered cost profile (test isolation)."""
    with _cost_lock:
        _costs.clear()


def cost_entries() -> Dict[str, dict]:
    """Every registered cost profile, keyed by fingerprint (entries are
    copies)."""
    with _cost_lock:
        return {k: dict(v) for k, v in _costs.items()}


# -- roofline math ------------------------------------------------------------

def roofline(flops: Optional[float], bytes_: Optional[float], dur_s: float,
             peak_tf: Optional[float] = None,
             peak_gb: Optional[float] = None) -> dict:
    """One dispatch on the roofline.

    Returns ``{achieved_tflops, achieved_gbs, mfu, intensity, ridge,
    bound}`` where ``bound`` is ``"compute_bound"`` / ``"bandwidth_bound"``
    / ``"unknown"``.  Degenerate inputs (no duration, zero/missing flops,
    bytes-only entries) fill None + ``"unknown"`` instead of raising —
    the reaper calls this per dispatch and must never die on a cost-less
    entry.  A bytes-only entry (flops absent, bytes known)
    is pure data movement and classifies ``bandwidth_bound``."""
    peak_tf = peak_tf if peak_tf is not None else peak_tflops()
    peak_gb = peak_gb if peak_gb is not None else peak_gbs()
    out: dict = {
        "achieved_tflops": None,
        "achieved_gbs": None,
        "mfu": None,
        "intensity": None,
        "ridge": round(peak_tf * 1e12 / (peak_gb * 1e9), 3)
        if peak_gb > 0 else None,
        "bound": "unknown",
    }
    try:
        dur_s = float(dur_s)
        flops = float(flops) if flops else None
        bytes_ = float(bytes_) if bytes_ else None
    except (TypeError, ValueError):
        return out
    if dur_s <= 0.0:
        return out
    if flops:
        out["achieved_tflops"] = flops / dur_s / 1e12
        if peak_tf > 0:
            out["mfu"] = flops / dur_s / (peak_tf * 1e12)
    if bytes_:
        out["achieved_gbs"] = bytes_ / dur_s / 1e9
    if flops and bytes_:
        out["intensity"] = flops / bytes_
        if out["ridge"] is not None:
            out["bound"] = ("compute_bound"
                            if out["intensity"] >= out["ridge"]
                            else "bandwidth_bound")
    elif bytes_ and not flops:
        out["bound"] = "bandwidth_bound"
    return out


# -- busy/idle interval accounting --------------------------------------------

def merge_intervals(intervals: Iterable[Tuple[int, int]]
                    ) -> List[Tuple[int, int]]:
    """Union of ``(start, end)`` intervals, sorted and coalesced —
    overlapping spans (dispatches enqueued behind each other, concurrent
    streams on one device) count their covered time once."""
    ivs = sorted((int(s), int(e)) for s, e in intervals if e > s)
    out: List[Tuple[int, int]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_fraction(intervals: Iterable[Tuple[int, int]], t0: int,
                  t1: int) -> Optional[float]:
    """Fraction of the window ``[t0, t1)`` covered by the (possibly
    overlapping) intervals; None for an empty window."""
    if t1 <= t0:
        return None
    covered = 0
    for s, e in merge_intervals(intervals):
        s, e = max(s, t0), min(e, t1)
        if e > s:
            covered += e - s
    return covered / (t1 - t0)


def idle_gaps(intervals: Iterable[Tuple[int, int]], min_gap: int,
              t0: Optional[int] = None, t1: Optional[int] = None
              ) -> List[Tuple[int, int]]:
    """``(start, duration)`` of every idle gap ≥ ``min_gap`` between the
    merged busy intervals (window edges included when ``t0``/``t1`` are
    given)."""
    merged = merge_intervals(intervals)
    gaps: List[Tuple[int, int]] = []
    if not merged:
        if t0 is not None and t1 is not None and t1 - t0 >= min_gap:
            gaps.append((t0, t1 - t0))
        return gaps
    if t0 is not None and merged[0][0] - t0 >= min_gap:
        gaps.append((t0, merged[0][0] - t0))
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        if s1 - e0 >= min_gap:
            gaps.append((e0, s1 - e0))
    if t1 is not None and t1 - merged[-1][1] >= min_gap:
        gaps.append((merged[-1][1], t1 - merged[-1][1]))
    return gaps


DEFAULT_BUSY_WINDOW_S = 10.0
DEFAULT_IDLE_GAP_MS = 5.0
DEFAULT_USAGE_CAP = 512


def configured_busy_window_s() -> float:
    """Sliding window for the busy-fraction gauge: ini ``[obs]
    busy_window_s`` (env ``NNSTPU_OBS_BUSY_WINDOW_S``)."""
    from ..conf import conf

    try:
        w = conf.get_float("obs", "busy_window_s", DEFAULT_BUSY_WINDOW_S)
    except ValueError:
        return DEFAULT_BUSY_WINDOW_S
    return w if w > 0 else DEFAULT_BUSY_WINDOW_S


def configured_idle_gap_ms() -> float:
    """Minimum device idle gap that becomes a ``device_idle`` flight
    span: ini ``[obs] device_idle_gap_ms``."""
    from ..conf import conf

    try:
        g = conf.get_float("obs", "device_idle_gap_ms", DEFAULT_IDLE_GAP_MS)
    except ValueError:
        return DEFAULT_IDLE_GAP_MS
    return g if g >= 0 else DEFAULT_IDLE_GAP_MS


class DeviceUsage:
    """Bounded per-device store of observed busy intervals.

    The :class:`~.device.DeviceTracer` reaper feeds one ``(enqueue,
    done)`` interval per observed dispatch; :meth:`busy_fractions` computes the sliding-window busy
    fraction per device at scrape time.  Intervals are host perf-counter
    nanoseconds — the same clock as every span.
    """

    def __init__(self, cap: int = DEFAULT_USAGE_CAP):
        self._cap = max(8, int(cap))
        self._lock = threading.Lock()
        self._by_device: Dict[str, deque] = {}

    def add(self, device: str, start_ns: int, end_ns: int) -> None:
        if end_ns <= start_ns:
            end_ns = start_ns + 1  # instantaneous completions still count
        with self._lock:
            dq = self._by_device.get(device)
            if dq is None:
                dq = self._by_device[device] = deque(maxlen=self._cap)
            dq.append((int(start_ns), int(end_ns)))

    def devices(self) -> List[str]:
        with self._lock:
            return sorted(self._by_device)

    def intervals(self, device: str) -> List[Tuple[int, int]]:
        with self._lock:
            return list(self._by_device.get(device, ()))

    def busy_fractions(self, window_ns: Optional[int] = None,
                       now_ns: Optional[int] = None) -> Dict[str, float]:
        """{device: busy fraction over the trailing window}.  The window
        is clipped to start no earlier than the oldest retained interval
        so a bounded ring never reads as idle time it simply forgot."""
        if window_ns is None:
            window_ns = int(configured_busy_window_s() * 1e9)
        now = now_ns if now_ns is not None else time.perf_counter_ns()
        out: Dict[str, float] = {}
        with self._lock:
            snap = {d: list(dq) for d, dq in self._by_device.items()}
        for device, ivs in snap.items():
            if not ivs:
                continue
            t0 = max(now - window_ns, min(s for s, _ in ivs))
            frac = busy_fraction(ivs, t0, now)
            if frac is not None:
                out[device] = frac
        return out

    def clear(self) -> None:
        with self._lock:
            self._by_device.clear()


# -- wire health: probes keyed by address, published live -------------------
#
# "local" is the host-to-device wire this process drives; partition edges
# add remote addresses, and the planner prices each cut at its own edge's
# put rate.

LOCAL_WIRE_ADDR = "local"

_wire_lock = threading.Lock()
_wire_by_addr: Dict[str, dict] = {}
_wire_registered = False
# addr -> zero-argument prober (returns a probe_wire_health-shaped dict); the
# watchdog's wire cadence runs these beside the local probe
_wire_edges: Dict[str, Callable[[], dict]] = {}


def wire_regime(put_ms: Optional[float]) -> str:
    """``"fast"`` / ``"slow"`` classification of a 150 KB put time."""
    if put_ms is None:
        return "unknown"
    return "slow" if put_ms > WIRE_SICK_PUT_MS else "fast"


def probe_wire_health(n: int = 20, nbytes: int = 150_528, device="cuda") -> dict:
    """Spot-check the host-to-device wire: ``n`` copies of ``nbytes`` (a
    224x224x3 frame) from pinned host memory into device tensors, timed by
    CUDA events around them (``put_150k_ms``, a copy), then ``n`` trivial
    dispatches (``x + 1``) timed on the host clock up to their completion
    (``dispatch_ms``, a dispatch).  Needs the card: there is nothing to
    probe on the CPU, and the probe raises there."""
    import numpy as np
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"probe_wire_health needs a CUDA device, got {dev}")
    rng = np.random.default_rng(1)
    host = [torch.from_numpy(rng.integers(0, 256, nbytes).astype(np.uint8)).pin_memory()
            for _ in range(n)]
    ds = [torch.empty(nbytes, dtype=torch.uint8, device=dev) for _ in range(n)]
    stream = torch.cuda.current_stream(dev)
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    begin.record(stream)
    for d, h in zip(ds, host):
        d.copy_(h, non_blocking=True)
    end.record(stream)
    end.synchronize()
    put_ms = begin.elapsed_time(end) / n
    t0 = time.perf_counter()
    for d in ds:
        out = d + 1
    torch.cuda.synchronize(dev)
    disp_ms = (time.perf_counter() - t0) / n * 1e3
    del out
    return {"put_150k_ms": round(put_ms, 3), "dispatch_ms": round(disp_ms, 3)}


def last_wire_health(addr: str = LOCAL_WIRE_ADDR) -> Optional[dict]:
    """The most recently published probe for ``addr`` (with its regime and
    timestamp), or None if it was never probed in this process."""
    with _wire_lock:
        record = _wire_by_addr.get(addr)
        return dict(record) if record is not None else None


def wire_health_by_addr() -> Dict[str, dict]:
    """Every published probe keyed by address (``"local"`` and any partition
    edges): the planner's per-edge put-rate input."""
    with _wire_lock:
        return {addr: dict(rec) for addr, rec in _wire_by_addr.items()}


def register_wire_edge(addr: str, prober: Callable[[], dict]) -> None:
    """Register a remote edge's prober: the watchdog's wire cadence runs
    every registered edge beside the local probe, so an edge's regime flip
    is observed without the planner polling."""
    with _wire_lock:
        _wire_edges[addr] = prober


def unregister_wire_edge(addr: str) -> None:
    with _wire_lock:
        _wire_edges.pop(addr, None)


def wire_edges() -> Dict[str, Callable[[], dict]]:
    """Snapshot of the registered edge probers by address."""
    with _wire_lock:
        return dict(_wire_edges)


def _wire_stats() -> dict:
    """The ``wire_health`` stats provider: the local record's flat shape,
    plus an ``edges`` map once a remote edge has been probed."""
    by_addr = wire_health_by_addr()
    out = dict(by_addr.get(LOCAL_WIRE_ADDR) or {})
    edges = {a: r for a, r in by_addr.items() if a != LOCAL_WIRE_ADDR}
    if edges:
        out["edges"] = edges
    return out


def publish_wire_health(health: dict,
                        registry: Optional[MetricsRegistry] = None,
                        addr: str = LOCAL_WIRE_ADDR) -> dict:
    """Republish one wire-health probe as live gauges and a stats provider.

    Sets ``nnstpu_wire_put_ms`` / ``nnstpu_wire_dispatch_ms`` /
    ``nnstpu_wire_regime`` (0 fast, 1 slow), labeled by ``addr``
    (``"local"``: the host-to-device wire; a partition edge publishes under
    its ``host:port``), and registers a ``wire_health``
    provider in ``/stats.json`` on the first publish.  Returns the stamped
    record."""
    global _wire_registered
    registry = registry if registry is not None else REGISTRY
    put_ms = health.get("put_150k_ms")
    regime = wire_regime(put_ms)
    record = dict(health)
    record["regime"] = regime
    record["probed_at"] = time.time()
    with _wire_lock:
        _wire_by_addr[addr] = record
        first = not _wire_registered
        _wire_registered = True
    if put_ms is not None:
        registry.gauge(
            "nnstpu_wire_put_ms",
            "Wire spot-check: ms per 150 KB flat put (addr: local = "
            "host-to-device, else a partition edge's host:port)",
            labelnames=("addr",),
        ).set(float(put_ms), addr=addr)
    if health.get("dispatch_ms") is not None:
        registry.gauge(
            "nnstpu_wire_dispatch_ms",
            "Wire spot-check: ms per trivial dispatch (by addr)",
            labelnames=("addr",),
        ).set(float(health["dispatch_ms"]), addr=addr)
    registry.gauge(
        "nnstpu_wire_regime",
        "Wire regime from the last spot-check (0 fast, 1 slow/sick), "
        "by addr",
        labelnames=("addr",),
    ).set(1.0 if regime == "slow" else 0.0, addr=addr)
    if first:
        from .export import register_stats

        register_stats("wire_health", _wire_stats)
    return dict(record)


def reset_wire_health() -> None:
    """Forget every probe, edge prober and the provider registration (test
    isolation)."""
    global _wire_registered
    from .export import unregister_stats

    with _wire_lock:
        _wire_by_addr.clear()
        _wire_edges.clear()
        _wire_registered = False
    unregister_stats("wire_health")
