"""Deep profiling lane: on-demand device traces, per-op device attribution,
and the device-memory ledger.

The port's copy of the JAX package's ``obs/profiler.py``.  The utilization
lane (``obs/util.py``) can say a dispatch is compute- or bandwidth-bound,
but not **which kernel** is responsible.  This module closes the loop from
the scrape endpoint to the kernels of one captured CUDA graph:

- **Windowed capture**: :func:`capture_profile` runs ``torch.profiler``
  (Kineto, with CUPTI's device activity on a card) around a bounded serving
  window and writes the Kineto trace (``<capture_id>.pt.trace.json``) into
  a bounded on-disk gallery (:class:`ProfileGallery`, newest K under a byte
  cap).  Kineto allows one profiler session per process, so exactly ONE
  capture runs at a time: a concurrent caller gets a typed
  :class:`ProfileBusyError` (HTTP 409 on ``GET /profile?seconds=N``,
  ``obs/export.py``).  Every entry that starts ``torch.profiler`` goes
  through that lock: :func:`capture_profile`, :func:`profiled_window`
  (``utils.profiling.device_trace``), the whole-run trace, and
  :func:`capture_lock` for code that drives its own profiler.  The
  session's start and stop hold the port's graph launches back
  (``obs/launch_gate.py``: a stop during a launch can hang).  The
  watchdog triggers a capture when a dispatch's device time degrades beyond
  the noise band (:class:`DegradeDetector`, ``[obs] profile_auto``).
- **Per-op attribution**: :func:`parse_capture_dir` reads the Kineto JSON
  into a table of ops.  Device rows come from the events of category
  ``kernel``, ``gpu_memcpy`` and ``gpu_memset``: CUPTI records them
  process-wide, whichever thread launched the work, so the table does not
  depend on the CPU ops of the capturing thread (a capture runs on the
  HTTP or the watchdog thread, the kernels are launched from queue or lane
  threads).  A CUDA graph's replay shows one record per kernel.  Host rows
  (``cpu_op``, recorded from every thread where the installed PyTorch can)
  are the fallback when there are no device events, the counterpart of the
  JAX package's host-plane fallback; ``device_planes`` counts the devices
  seen.  The JAX package's XPlane proto walker and its text-event fallback
  (``parse_xspace``, ``parse_text_events``) have no counterpart: the port
  never writes an XPlane file.  Ops are joined to the cost registry's
  capture fingerprints through the ``device_exec`` emissions observed
  during the window (the ``device`` tracer's reaper), rolled up by
  category (:func:`categorize_op`: matmul/conv/elementwise/copy/infeed),
  exported as ``nnstpu_op_time_us{executable,op_category}``, and
  :func:`annotate_chrome_trace` links ``device_exec`` spans of a
  Chrome-trace document to the capture's table.
- **Device-memory ledger**: the backend records a memory footprint per
  captured CUDA graph on its cost-registry entry (``obs/device.py``
  :func:`~.device.memory_info`, the counterpart of XLA's
  ``memory_analysis()``), under the JAX package's kinds:
  ``argument_bytes`` (the parameters and the static inputs, as an XLA
  executable's arguments are), ``output_bytes`` (the static outputs),
  ``temp_bytes`` (the graph's private pool less its outputs),
  ``alias_bytes`` and ``generated_code_bytes`` (0: a replay aliases nothing
  and keeps no code of its own), plus the port's ``parameter_bytes`` and
  ``input_bytes``, the two parts of ``argument_bytes``.  The resident set
  of a graph is then its private pool, output and temp bytes together.
  :func:`register_hbm_gauges` exposes ``nnstpu_executable_hbm_bytes
  {executable,kind}``, :func:`check_hbm_capacity` compares the sum against
  the card's memory (:func:`device_capacity_bytes`, from
  ``torch.cuda.mem_get_info``) before PLAYING (a typed
  :class:`HbmCapacityWarning` and a degraded reason, never a start
  failure), and :func:`hbm_ledger` is what an error's flight dump embeds.

``[common] xplane_trace_dir`` (the key keeps its name; the artifacts are
Kineto JSON) traces the whole PLAYING interval through the same machinery
(:func:`start_whole_run` / :func:`stop_whole_run`): the raw trace lands in
the user's directory, the parsed summary in the gallery, failures surface
through the ``health`` hook and the degraded registry, and the trace holds
the capture lock, so ``/profile`` during it answers the same 409.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from . import hooks as _hooks
from .launch_gate import switching
from .metrics import REGISTRY, MetricsRegistry

TRACE_SUFFIX = ".pt.trace.json"
SUMMARY_SUFFIX = ".profile.json"

# frames-bounded captures still need a wall-clock ceiling (a stalled
# pipeline must not hold the capture lock forever)
FRAMES_TIMEOUT_S = 30.0
_TICK_S = 0.05

# Kineto trace categories of the device's own activity
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORY = "cpu_op"


class ProfileBusyError(RuntimeError):
    """A capture is already running (one at a time, process-wide).  The
    ``/profile`` endpoint maps this to HTTP 409."""

    status = 409

    def __init__(self, active: Optional[dict] = None):
        self.active = dict(active or {})
        detail = self.active.get("capture_id") or "capture in progress"
        super().__init__(f"profile capture busy: {detail}")


class ProfiledReplayHazard(RuntimeError):
    """ROADMAP C16, raised instead of a crash: a training step's CUDA graph
    (``training.py``) was about to replay inside an open ``torch.profiler``
    window while a training graph captured after it, on a thread other than
    the main one, is alive.  On the H100 that replay has killed the process
    inside ``CUDAGraph.replay`` when the window traces CUDA activity
    (CUPTI); a window of CPU activity alone survives it.  The cause lies
    below the port, so the step refuses the replay typed before the launch.
    Replay outside the window, or drop the later trainer first."""


class HbmCapacityWarning(RuntimeWarning):
    """The per-pipeline resident-set estimate of the captured graphs
    exceeds the card's memory: warmup surfaces this as a typed warning
    (serving may still work: the caching allocator's reuse is not
    modelled), never a start failure."""


# -- conf ---------------------------------------------------------------------

def _conf_float(key: str, default: float) -> float:
    from ..conf import conf

    try:
        return conf.get_float("obs", key, default)
    except ValueError:
        return default


def _conf_int(key: str, default: int) -> int:
    return int(_conf_float(key, float(default)))


def configured_dir() -> str:
    """``[obs] profile_dir`` ("" = a per-process temp gallery)."""
    from ..conf import conf

    return conf.get_path("obs", "profile_dir", "") or ""


def configured_default_seconds() -> float:
    return max(0.05, _conf_float("profile_default_seconds", 2.0))


def configured_top_k() -> int:
    return max(1, _conf_int("profile_top_k", 20))


# -- the capture gallery ------------------------------------------------------

def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(root, fn))
            except OSError:
                continue
    return total


class ProfileGallery:
    """Bounded on-disk capture gallery: newest K retained, byte-capped.

    Each capture owns ``<dir>/<capture_id>/`` (the Kineto trace) plus
    ``<dir>/<capture_id>.profile.json`` (the parsed summary).  Profiles
    rank by recency: the newest captures answer "what is the device doing
    NOW".  The directory is rescanned at init, so a restarted process keeps
    honoring the bound across its predecessor's captures."""

    def __init__(self, dirpath: str, keep: int, max_bytes: int):
        self.dir = dirpath
        self.keep = max(1, int(keep))
        self.max_bytes = max(0, int(max_bytes))
        self.evicted = 0
        self._lock = threading.Lock()
        # (recency key, capture_id, bytes)
        self._entries: List[Tuple[float, str, int]] = []
        os.makedirs(dirpath, exist_ok=True)
        for fname in sorted(os.listdir(dirpath)):
            if not fname.endswith(SUMMARY_SUFFIX):
                continue
            cid = fname[:-len(SUMMARY_SUFFIX)]
            try:
                with open(os.path.join(dirpath, fname)) as f:
                    when = float(json.load(f).get("started_unix") or 0.0)
            except Exception:  # noqa: BLE001 - a corrupt summary is not load-bearing
                when = 0.0
            self._entries.append((when, cid, self._entry_bytes(cid)))
        self._entries.sort()

    def capture_dir(self, capture_id: str) -> str:
        return os.path.join(self.dir, capture_id)

    def summary_path(self, capture_id: str) -> str:
        return os.path.join(self.dir, capture_id + SUMMARY_SUFFIX)

    def _entry_bytes(self, capture_id: str) -> int:
        total = 0
        try:
            total += os.path.getsize(self.summary_path(capture_id))
        except OSError:
            pass
        cdir = self.capture_dir(capture_id)
        if os.path.isdir(cdir):
            total += _dir_bytes(cdir)
        return total

    def add(self, capture_id: str, summary: dict) -> Optional[str]:
        """Write one capture's summary and evict the oldest entries until
        the bounds hold.  Returns the summary path, or None when the write
        failed or the capture itself fell straight out."""
        path = self.summary_path(capture_id)
        data = json.dumps(summary, indent=1, sort_keys=True, default=str).encode("utf-8")
        with self._lock:
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            except OSError:
                return None
            self._entries = [e for e in self._entries if e[1] != capture_id]
            self._entries.append((float(summary.get("started_unix") or 0.0), capture_id,
                                  self._entry_bytes(capture_id)))
            self._entries.sort()
            kept: Optional[str] = path
            while len(self._entries) > self.keep or (
                    self.max_bytes and sum(e[2] for e in self._entries) > self.max_bytes
                    and len(self._entries) > 1):
                victim = self._entries.pop(0)  # oldest first
                self.evicted += 1
                self._remove_entry(victim[1])
                if victim[1] == capture_id:
                    kept = None
            return kept

    def _remove_entry(self, capture_id: str) -> None:
        import shutil

        try:
            os.remove(self.summary_path(capture_id))
        except OSError:
            pass
        shutil.rmtree(self.capture_dir(capture_id), ignore_errors=True)

    def entries(self) -> List[str]:
        with self._lock:
            return [cid for _w, cid, _b in self._entries]

    def summary(self) -> dict:
        with self._lock:
            return {"dir": self.dir, "entries": len(self._entries),
                    "bytes": sum(e[2] for e in self._entries), "evicted": self.evicted}


_gallery_lock = threading.Lock()
_gallery: Optional[ProfileGallery] = None
_tmp_gallery_dir: Optional[str] = None


def gallery() -> ProfileGallery:
    """The process gallery for the conf's ``[obs] profile_dir`` (resolved
    again when the conf changes; "" falls back to one per-process temp
    dir, so ``/profile`` works out of the box)."""
    global _gallery, _tmp_gallery_dir
    root = configured_dir()
    with _gallery_lock:
        if not root:
            if _tmp_gallery_dir is None:
                _tmp_gallery_dir = tempfile.mkdtemp(prefix="nnstpu-profile-")
            root = _tmp_gallery_dir
        if _gallery is None or _gallery.dir != root:
            _gallery = ProfileGallery(root, keep=_conf_int("profile_keep", 4),
                                      max_bytes=_conf_int("profile_max_bytes", 64 * 1024 * 1024))
        return _gallery


def reset_gallery() -> None:
    """Drop the cached gallery object (test isolation; files stay)."""
    global _gallery
    with _gallery_lock:
        _gallery = None


# -- op categories ------------------------------------------------------------
#
# Name rules over CUDA kernel names (cuBLAS, CUTLASS, cuDNN, ATen and the
# port's own kernels, csrc/*.cu) and, for the host fallback, ATen op names.
# The first rule whose needle the lower-cased name contains wins, so the
# specific rules come first: a cuDNN conv's implicit GEMM
# ("sm90_xmma_fprop_implicit_gemm_...") is a conv, and a layout transform
# inside cuDNN ("nchwToNhwcKernel") is a copy.
_CATEGORY_RULES = (
    ("copy", ("memcpy", "memset", "nchwtonhwc", "nhwctonchw", "addpadding")),
    # the port's own kernels (csrc/fused_arith.cu, int8_matmul.cu, nms_keep.cu)
    ("elementwise", ("fused_arith_kernel",)),
    ("matmul", ("int8_gemv_splitk_kernel", "int8_matmul_kernel")),
    ("other", ("nms_bits_kernel", "nms_walk_kernel")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit_gemm",
              "implicit_sgemm", "fft2d", "cudnn")),
    # nvjet: cuBLASLt's Hopper GEMM kernels (1x1 convs at batch 1 run there)
    ("matmul", ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet", "matmul", "aten::mm",
                "aten::addmm", "aten::bmm", "aten::_int_mm", "aten::linear", "dot",
                "attention", "fmha", "flash")),
    ("infeed", ("htod", "dtoh", "h2d", "d2h", "pinned", "pageable")),
    ("elementwise", ("elementwise", "reduce", "softmax", "norm", "multi_tensor_apply",
                     "fill", "relu", "clamp", "sigmoid", "tanh", "exp", "pow", "where",
                     "add", "sub", "mul", "div", "max", "min", "sum", "mean", "rsqrt",
                     "sqrt", "abs", "neg")),
    ("copy", ("copy", "cat", "transpose", "permute", "gather", "scatter", "index", "pad",
              "slice", "reshape", "view", "contiguous")),
)


def categorize_op(name: str) -> str:
    low = name.lower()
    for cat, needles in _CATEGORY_RULES:
        for needle in needles:
            if needle in low:
                return cat
    return "other"


# -- Kineto trace parsing -------------------------------------------------------

def find_trace_files(capture_dir: str) -> List[str]:
    out: List[str] = []
    for root, _dirs, files in os.walk(capture_dir):
        for fn in files:
            if fn.endswith(TRACE_SUFFIX):
                out.append(os.path.join(root, fn))
    return sorted(out)


def read_trace_events(path: str) -> Tuple[Dict[str, List[float]], Dict[str, List[float]],
                                           List[str]]:
    """One Kineto trace's op tables: ``(device_ops, host_ops, devices)``,
    each table ``{name: [total_dur_us, count]}`` over the complete
    (``"ph": "X"``) events, device rows from :data:`DEVICE_CATEGORIES` and
    host rows from ``cpu_op``; ``devices`` names each device seen
    (``args.device``)."""
    with open(path) as f:
        doc = json.load(f)
    device_ops: Dict[str, List[float]] = {}
    host_ops: Dict[str, List[float]] = {}
    devices = set()
    for ev in doc.get("traceEvents") or ():
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat in DEVICE_CATEGORIES:
            target = device_ops
            devices.add(str((ev.get("args") or {}).get("device", ev.get("pid", 0))))
        elif cat == HOST_CATEGORY:
            target = host_ops
        else:
            continue
        entry = target.setdefault(str(ev.get("name", "")), [0.0, 0])
        entry[0] += float(ev.get("dur") or 0.0)
        entry[1] += 1
    return device_ops, host_ops, sorted(devices)


def parse_trace_files(files: Iterable[str], root: str = "",
                      top_k: Optional[int] = None) -> dict:
    """The op table of the Kineto traces ``files``: device rows when any
    trace holds device events, else the host rows (gate device-specific
    assertions on ``device_planes > 0``)."""
    top_k = top_k if top_k is not None else configured_top_k()
    files = list(files)
    device_ops: Dict[str, List[float]] = {}
    host_ops: Dict[str, List[float]] = {}
    devices = set()
    for path in files:
        try:
            dev, host, seen = read_trace_events(path)
        except (OSError, ValueError):  # an unreadable trace never fails the capture
            continue
        devices.update(seen)
        for src, dst in ((dev, device_ops), (host, host_ops)):
            for name, (dur, n) in src.items():
                agg = dst.setdefault(name, [0.0, 0])
                agg[0] += dur
                agg[1] += n
    planes = [f"/device:cuda:{d}" for d in sorted(devices)]
    if host_ops:
        planes.append("/host:CPU")
    ops = device_ops if device_ops else host_ops
    rows = [{"name": name, "category": categorize_op(name), "dur_us": round(dur, 3),
             "count": n} for name, (dur, n) in ops.items()]
    rows.sort(key=lambda r: (-r["dur_us"], -r["count"], r["name"]))
    categories: Dict[str, float] = {}
    for r in rows:
        categories[r["category"]] = round(categories.get(r["category"], 0.0) + r["dur_us"], 3)
    return {
        "parser": "kineto",
        "artifacts": [os.path.relpath(p, root) if root else p for p in files],
        "planes": planes,
        "device_planes": len(devices),
        "ops_total": len(rows),
        "device_us_total": round(sum(r["dur_us"] for r in rows), 3) if device_ops else 0.0,
        "ops": rows[:top_k],
        "op_categories": categories,
    }


def parse_capture_dir(capture_dir: str, top_k: Optional[int] = None) -> dict:
    """Parse every Kineto trace under ``capture_dir`` into the op table
    (:func:`parse_trace_files`)."""
    return parse_trace_files(find_trace_files(capture_dir), root=capture_dir, top_k=top_k)


# -- the profiler session -----------------------------------------------------

def _profiler_start():
    """Start one ``torch.profiler`` session: CPU ops from every thread (where
    the installed PyTorch offers ``profile_all_threads``) and, with a card,
    CUPTI's device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kwargs = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kwargs["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = profile(activities=activities, **kwargs)
    with switching():  # no graph launch meanwhile (ROADMAP C17)
        prof.start()
    return prof


def _profiler_stop(prof, path: Optional[str]) -> None:
    """Stop the session, the device work enqueued so far finished first, and
    write its Kineto trace to ``path`` (None: no file)."""
    import torch

    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        with switching():  # no graph launch meanwhile (ROADMAP C17)
            prof.stop()
    if path is not None:
        prof.export_chrome_trace(path)


# -- the capture state machine ------------------------------------------------

_capture_lock = threading.Lock()
_active_lock = threading.Lock()
_active: Optional[dict] = None  # {"capture_id", "trigger", "whole_run"}

_last_lock = threading.Lock()
_recent: "deque[dict]" = deque(maxlen=8)

_seq_lock = threading.Lock()
_seq = 0


def _next_capture_id(trigger: str) -> str:
    global _seq
    with _seq_lock:
        _seq += 1
        n = _seq
    return f"{time.strftime('%Y%m%d-%H%M%S')}.{os.getpid()}.{n:03d}.{trigger}"


def _acquire(trigger: str, capture_id: str, whole_run: bool = False) -> None:
    global _active
    if not _capture_lock.acquire(blocking=False):
        with _active_lock:
            raise ProfileBusyError(_active)
    with _active_lock:
        _active = {"capture_id": capture_id, "trigger": trigger, "whole_run": whole_run}


def _release() -> None:
    global _active
    with _active_lock:
        _active = None
    _capture_lock.release()


@contextlib.contextmanager
def capture_lock(label: str = "external", trigger: str = "manual"):
    """Hold the process-wide capture lock around code that runs a
    ``torch.profiler`` session of its own (Kineto allows one a process):
    raises :class:`ProfileBusyError` when a capture holds it, and makes
    ``/profile`` answer 409 meanwhile."""
    capture_id = _next_capture_id(trigger)
    _acquire(trigger, capture_id)
    try:
        _emit("start", f"{capture_id} ({label})")
        yield capture_id
    finally:
        _release()
        _emit("end", f"{capture_id} ({label})")


def active_capture() -> Optional[dict]:
    """The in-flight capture's descriptor, or None."""
    with _active_lock:
        return dict(_active) if _active is not None else None


def last_capture() -> Optional[dict]:
    """The most recent completed capture summary."""
    with _last_lock:
        return dict(_recent[-1]) if _recent else None


def recent_captures() -> List[dict]:
    with _last_lock:
        return [dict(s) for s in _recent]


def _remember(summary: dict) -> None:
    with _last_lock:
        _recent.append(dict(summary))


def _captures_counter(registry: MetricsRegistry):
    return registry.counter(
        "nnstpu_profile_captures_total",
        "Deep-profiling captures, by trigger (manual/http/watchdog/whole_run) and outcome",
        labelnames=("trigger", "outcome"),
    )


def _export_op_gauges(summary: dict, registry: Optional[MetricsRegistry] = None) -> None:
    """``nnstpu_op_time_us{executable,op_category}``: the last capture's
    per-category device time, attributed to the capture fingerprints
    observed during the window."""
    registry = registry if registry is not None else REGISTRY
    gauge = registry.gauge(
        "nnstpu_op_time_us",
        "Per-op-category device time (us) from the most recent deep-profiling capture, "
        "keyed to the cost registry's capture fingerprint",
        labelnames=("executable", "op_category"),
    )
    per: Dict[Tuple[str, str], float] = {}
    for row in summary.get("ops") or ():
        key = (row.get("executable") or "", row["category"])
        per[key] = per.get(key, 0.0) + float(row["dur_us"])
    for (executable, category), dur in per.items():
        gauge.set(round(dur, 3), executable=executable, op_category=category)


class _FingerprintWatch:
    """Collect the capture fingerprints whose ``device_exec`` completions
    landed inside the window: the join key between the op rows and the
    cost registry."""

    def __init__(self):
        self.lock = threading.Lock()
        self.by_key: Dict[str, List[float]] = {}  # fp -> [dur_us_sum, n]
        self.frames = 0

    def on_device_exec(self, pipeline_name, node_name, device, t0_ns, dur_ns, info) -> None:
        del pipeline_name, node_name, device, t0_ns
        fp = (info or {}).get("cost_key")
        with self.lock:
            self.frames += 1
            if fp:
                entry = self.by_key.setdefault(fp, [0.0, 0])
                entry[0] += dur_ns / 1e3
                entry[1] += 1

    def connect(self) -> None:
        _hooks.connect("device_exec", self.on_device_exec)

    def disconnect(self) -> None:
        _hooks.disconnect("device_exec", self.on_device_exec)

    def snapshot(self) -> Dict[str, dict]:
        with self.lock:
            return {fp: {"dur_us": round(e[0], 3), "dispatches": e[1]}
                    for fp, e in self.by_key.items()}


def _attribute_executables(parsed: dict, observed: Dict[str, dict]) -> None:
    """Stamp each op row's ``executable``: with exactly one fingerprint
    observed during the window every op joins it; with several, a
    model-name substring match wins, else the dominant (most device time)
    fingerprint.  The summary carries the full observed table beside it."""
    if not observed:
        return
    dominant = max(observed, key=lambda fp: observed[fp]["dur_us"])
    single = list(observed)[0] if len(observed) == 1 else None
    names = {fp: fp.split(":", 1)[0].lower() for fp in observed}
    for row in parsed.get("ops") or ():
        if single is not None:
            row["executable"] = single
            continue
        low = row["name"].lower()
        row["executable"] = next((fp for fp, model in names.items() if model and model in low),
                                 dominant)


def _emit(action: str, detail: str, pipeline=None) -> None:
    if _hooks.enabled:
        _hooks.emit("profile", getattr(pipeline, "name", "") or "", action, detail)


def _trace_path(capture_dir: str, capture_id: str) -> str:
    return os.path.join(capture_dir, capture_id + TRACE_SUFFIX)


def capture_profile(seconds: Optional[float] = None, frames: Optional[int] = None,
                    pipeline=None, trigger: str = "manual",
                    registry: Optional[MetricsRegistry] = None) -> dict:
    """One bounded profiling window: start ``torch.profiler``, serve for
    ``seconds`` (or until ``frames`` device completions, capped at
    ``FRAMES_TIMEOUT_S``), stop, parse, bank into the gallery, export the op
    gauges.  Raises :class:`ProfileBusyError` when a capture (or a
    whole-run trace) already holds the window.  A ``pipeline`` that leaves
    PLAYING mid-window (stop, error) ends the window early and the summary
    records the abandonment; never an error.  The returned summary is also
    what ``GET /profile`` serves."""
    registry = registry if registry is not None else REGISTRY
    if seconds is None and frames is None:
        seconds = configured_default_seconds()
    capture_id = _next_capture_id(trigger)
    _acquire(trigger, capture_id)
    try:
        gal = gallery()
        capture_dir = gal.capture_dir(capture_id)
        os.makedirs(capture_dir, exist_ok=True)
        watch = _FingerprintWatch()
        summary = {
            "kind": "profile_capture",
            "capture_id": capture_id,
            "trigger": trigger,
            "pipeline": getattr(pipeline, "name", "") or "",
            "started_unix": time.time(),
            "requested_seconds": seconds,
            "requested_frames": frames,
            "aborted": "",
            "artifact_dir": capture_dir,
        }
        _emit("start", capture_id, pipeline)
        watch.connect()
        try:
            prof = _profiler_start()
            # the window opens once the profiler runs (its start takes a
            # while the first time in a process)
            t0 = time.monotonic()
            try:
                deadline = t0 + (seconds if seconds is not None else FRAMES_TIMEOUT_S)
                while time.monotonic() < deadline:
                    if frames is not None and watch.frames >= frames:
                        break
                    if pipeline is not None and pipeline.state != "PLAYING":
                        summary["aborted"] = f"pipeline left PLAYING (state={pipeline.state})"
                        break
                    time.sleep(_TICK_S)
            finally:
                _profiler_stop(prof, _trace_path(capture_dir, capture_id))
        finally:
            watch.disconnect()
        summary["seconds"] = round(time.monotonic() - t0, 3)
        summary["frames_observed"] = watch.frames
        observed = watch.snapshot()
        summary["executables"] = observed
        parsed = parse_capture_dir(capture_dir)
        _attribute_executables(parsed, observed)
        summary.update(parsed)
        summary["summary_path"] = gal.add(capture_id, summary)
        _export_op_gauges(summary, registry)
        _remember(summary)
        outcome = "aborted" if summary["aborted"] else "ok"
        _captures_counter(registry).inc(1, trigger=trigger, outcome=outcome)
        _emit("end" if outcome == "ok" else "abort",
              f"{capture_id}: {summary['ops_total']} ops, {summary['frames_observed']} frames"
              + (f"; {summary['aborted']}" if summary["aborted"] else ""), pipeline)
        return summary
    finally:
        _release()


@contextlib.contextmanager
def profiled_window(label: str = "window", logdir: Optional[str] = None,
                    trigger: str = "manual", parse: bool = True):
    """Low-level capture bracket for code that drives its own workload
    (``utils.profiling.device_trace``): serialized on the same process-wide
    capture lock (typed busy, never a second Kineto session), the trace in
    the gallery or the caller's ``logdir``.  Yields a dict that carries
    ``summary`` after the block exits (with ``parse``)."""
    capture_id = _next_capture_id(trigger)
    _acquire(trigger, capture_id)
    holder: dict = {"capture_id": capture_id, "label": label}
    try:
        gal = gallery() if logdir is None else None
        capture_dir = logdir or gal.capture_dir(capture_id)
        os.makedirs(capture_dir, exist_ok=True)
        _emit("start", f"{capture_id} ({label})")
        prof = _profiler_start()
        t0 = time.monotonic()
        try:
            yield holder
        finally:
            path = _trace_path(capture_dir, capture_id)
            _profiler_stop(prof, path)
            if parse:
                summary = {
                    "kind": "profile_capture",
                    "capture_id": capture_id,
                    "trigger": trigger,
                    "label": label,
                    "pipeline": "",
                    "started_unix": time.time(),
                    "seconds": round(time.monotonic() - t0, 3),
                    "aborted": "",
                    "artifact_dir": capture_dir,
                    "executables": {},
                }
                summary.update(parse_trace_files([path], root=capture_dir))
                if gal is not None:
                    summary["summary_path"] = gal.add(capture_id, summary)
                _remember(summary)
                _captures_counter(REGISTRY).inc(1, trigger=trigger, outcome="ok")
                holder["summary"] = summary
            _emit("end", f"{capture_id} ({label})")
    finally:
        _release()


# -- the whole-run trace (``[common] xplane_trace_dir``) ------------------------

_whole_run_lock = threading.Lock()
_whole_run: Dict[int, dict] = {}  # id(pipeline) -> state


def start_whole_run(pipeline, trace_dir: str) -> bool:
    """``Pipeline``'s entry at PLAYING: one trace of the whole PLAYING
    interval into the user's ``trace_dir``, holding the capture lock so
    ``/profile`` answers 409 meanwhile.  Returns True when tracing started;
    a failure surfaces through the ``health`` hook and the degraded
    registry (:func:`_surface_failure`), never as an exception."""
    capture_id = _next_capture_id("whole_run")
    try:
        _acquire("whole_run", capture_id, whole_run=True)
    except ProfileBusyError as exc:
        _surface_failure(pipeline, f"xplane whole-run trace skipped: {exc}")
        return False
    try:
        os.makedirs(trace_dir, exist_ok=True)
        prof = _profiler_start()
    except Exception as exc:  # noqa: BLE001 - observability must not fail a start
        _release()
        _surface_failure(pipeline, f"xplane whole-run trace start failed: {exc!r}")
        return False
    with _whole_run_lock:
        _whole_run[id(pipeline)] = {"capture_id": capture_id, "trace_dir": trace_dir,
                                    "started_unix": time.time(), "t0": time.monotonic(),
                                    "profiler": prof}
    _emit("start", f"{capture_id} (whole_run -> {trace_dir})", pipeline)
    return True


def stop_whole_run(pipeline) -> Optional[dict]:
    """``Pipeline.stop``'s half: stop the trace, write it into the user's
    directory, parse it and bank the summary (only the summary: the raw
    trace belongs to the user's directory and is never evicted).  Never
    raises."""
    with _whole_run_lock:
        state = _whole_run.pop(id(pipeline), None)
    if state is None:
        return None
    summary: Optional[dict] = None
    try:
        path = _trace_path(state["trace_dir"], state["capture_id"])
        _profiler_stop(state["profiler"], path)
        summary = {
            "kind": "profile_capture",
            "capture_id": state["capture_id"],
            "trigger": "whole_run",
            "pipeline": getattr(pipeline, "name", "") or "",
            "started_unix": state["started_unix"],
            "seconds": round(time.monotonic() - state["t0"], 3),
            "aborted": "",
            "artifact_dir": state["trace_dir"],
            "executables": {},
        }
        summary.update(parse_trace_files([path], root=state["trace_dir"]))
        summary["summary_path"] = gallery().add(state["capture_id"], summary)
        _export_op_gauges(summary)
        _remember(summary)
        _captures_counter(REGISTRY).inc(1, trigger="whole_run", outcome="ok")
        _emit("end", state["capture_id"], pipeline)
    except Exception as exc:  # noqa: BLE001 - stop() must complete
        _captures_counter(REGISTRY).inc(1, trigger="whole_run", outcome="error")
        _surface_failure(pipeline, f"xplane whole-run trace stop failed: {exc!r}")
    finally:
        _release()
    return summary


def _surface_failure(pipeline, reason: str) -> None:
    """A whole-run trace's failure as observability: the ``health`` hook
    (healthy stays True: a lost trace is degraded evidence, not a broken
    pipeline) and a degraded reason on ``/healthz``."""
    from .export import register_degraded

    _emit("error", reason, pipeline)
    if _hooks.enabled:
        _hooks.emit("health", pipeline, True, reason)
    pname = getattr(pipeline, "name", "") or "pipeline"
    register_degraded(f"xplane:{pname}", lambda r=reason: r)


# -- the device-memory ledger ---------------------------------------------------

# resident while serving: the graph's private pool (outputs and temps) and
# code; argument bytes (parameters shared by a model's graphs, and the
# static inputs each frame is copied into) are reported separately
_RESIDENT_KINDS = ("output_bytes", "temp_bytes", "generated_code_bytes")


def hbm_ledger() -> dict:
    """The per-capture memory ledger out of the cost registry (the backend
    records :func:`~.device.memory_info` per captured graph):
    ``{"executables": {fp: {kind: bytes, "resident_bytes": ...}},
    "largest_resident": fp, "resident_estimate_bytes": total}``.  Empty
    when no entry carries memory data (before any capture, or on the CPU,
    where nothing is captured).  This is what an error's flight dump
    embeds."""
    from . import util as _util

    executables: Dict[str, dict] = {}
    total = 0
    largest: Optional[str] = None
    largest_bytes = -1
    for fp, entry in _util.cost_entries().items():
        hbm = entry.get("hbm")
        if not isinstance(hbm, dict) or not hbm:
            continue
        row = {k: int(v) for k, v in hbm.items() if isinstance(v, (int, float))}
        resident = sum(row.get(k, 0) for k in _RESIDENT_KINDS)
        row["resident_bytes"] = resident
        executables[fp] = row
        total += resident
        if resident > largest_bytes:
            largest, largest_bytes = fp, resident
    if not executables:
        return {}
    return {"executables": executables, "largest_resident": largest,
            "resident_estimate_bytes": total}


_hbm_gauges_lock = threading.Lock()
_hbm_gauges_installed: Dict[int, object] = {}


def register_hbm_gauges(registry: Optional[MetricsRegistry] = None):
    """``nnstpu_executable_hbm_bytes{executable,kind}``: every cost-registry
    entry's memory bytes, refreshed at scrape time (a registry collector).
    Idempotent per registry; returns the collector handle."""
    registry = registry if registry is not None else REGISTRY
    with _hbm_gauges_lock:
        handle = _hbm_gauges_installed.get(id(registry))
        if handle is not None:
            return handle
        gauge = registry.gauge(
            "nnstpu_executable_hbm_bytes",
            "Per-capture device memory (bytes) by kind (argument/parameter/input/output/"
            "temp/alias/generated_code/resident), keyed by the cost registry's capture "
            "fingerprint",
            labelnames=("executable", "kind"),
        )

        def collect():
            for fp, row in (hbm_ledger().get("executables") or {}).items():
                for kind, val in row.items():
                    gauge.set(val, executable=fp, kind=kind)

        handle = registry.add_collector(collect)
        _hbm_gauges_installed[id(registry)] = handle
        return handle


def device_capacity_bytes(devices=None) -> Optional[int]:
    """The smallest card's memory (``torch.cuda.mem_get_info``'s total, the
    device snapshot's ``bytes_limit``), or None without a card in use."""
    from .device import device_memory_snapshot

    limits = [stats["bytes_limit"] for stats in device_memory_snapshot(devices).values()
              if isinstance(stats.get("bytes_limit"), int) and stats["bytes_limit"] > 0]
    return min(limits) if limits else None


def check_hbm_capacity(pipeline=None, devices=None,
                       capacity_bytes: Optional[int] = None) -> dict:
    """Warmup's residency check before PLAYING: the captured graphs'
    resident-set estimates summed against the card's memory.  Over capacity
    is a typed :class:`HbmCapacityWarning` naming the largest graph and a
    degraded reason on ``/healthz``, **never** a start failure.  The report
    lands on ``pipeline.hbm_report``."""
    ledger = hbm_ledger()
    capacity = capacity_bytes if capacity_bytes is not None else device_capacity_bytes(devices)
    report = {
        "resident_estimate_bytes": ledger.get("resident_estimate_bytes", 0),
        "largest_resident": ledger.get("largest_resident"),
        "capacity_bytes": capacity,
        "executables": len(ledger.get("executables") or {}),
        "over_capacity": False,
    }
    if capacity is not None and ledger and report["resident_estimate_bytes"] > capacity:
        import warnings

        from .export import register_degraded

        report["over_capacity"] = True
        reason = (f"estimated executable resident set {report['resident_estimate_bytes']} B "
                  f"exceeds device capacity {capacity} B (largest: "
                  f"{report['largest_resident']})")
        warnings.warn(reason, HbmCapacityWarning, stacklevel=2)
        pname = getattr(pipeline, "name", "") or "pipeline"
        register_degraded(f"hbm:{pname}", lambda r=reason: r)
        _emit("hbm_over_capacity", reason, pipeline)
    if pipeline is not None:
        pipeline.hbm_report = report
    return report


# -- the Chrome-trace drill-down join -----------------------------------------

def annotate_chrome_trace(doc: dict, summary: Optional[dict] = None) -> dict:
    """Join the most recent capture's table into a Chrome-trace document:
    the top-K op table and the category rollup land under
    ``otherData.profile_drilldown``, and every ``device_exec`` span whose
    ``cost_key`` matches an attributed capture gets a ``profile_capture``
    arg pointing at it.  No capture: the doc passes through untouched."""
    summary = summary if summary is not None else last_capture()
    if not summary:
        return doc
    drill = {
        "capture_id": summary.get("capture_id"),
        "trigger": summary.get("trigger"),
        "parser": summary.get("parser"),
        "ops": summary.get("ops") or [],
        "op_categories": summary.get("op_categories") or {},
        "executables": summary.get("executables") or {},
    }
    doc.setdefault("otherData", {})["profile_drilldown"] = drill
    attributed = {row.get("executable") for row in drill["ops"] if row.get("executable")}
    attributed |= set(drill["executables"])
    for ev in doc.get("traceEvents") or ():
        if ev.get("ph") != "X" or ev.get("name") != "device_exec":
            continue
        args = ev.get("args")
        if not isinstance(args, dict):
            continue
        if not attributed or args.get("cost_key") in attributed:
            args["profile_capture"] = drill["capture_id"]
    return doc


# -- degrade detection (the watchdog's auto-capture trigger) ------------------

# The noise band of the JAX package's cost model (obs/costmodel.py, not
# ported): max(min_rel x |mean|, min_abs_us, sigmas x sample std).
BAND_SIGMAS = 3.0
BAND_MIN_REL = 0.10
BAND_MIN_ABS_US = 5.0


class _LegStat:
    """One key's accumulator: exact mean and M2 (Welford) and an EWMA, µs."""

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
        self.ewma_us = us if self.count == 1 else alpha * us + (1.0 - alpha) * self.ewma_us
        self.last_us = us

    def snapshot(self) -> dict:
        return {"count": self.count, "mean_us": round(self.mean_us, 3),
                "ewma_us": round(self.ewma_us, 3), "m2": round(self.m2, 3)}


def _leg_band_us(leg: dict, sigmas: float = BAND_SIGMAS, min_rel: float = BAND_MIN_REL,
                 min_abs_us: float = BAND_MIN_ABS_US) -> float:
    """The noise band (µs) around a persisted aggregate's mean; below 2
    samples only the relative and absolute floors apply."""
    mean = float(leg.get("mean_us") or 0.0)
    band = max(min_rel * abs(mean), min_abs_us)
    n = int(leg.get("count") or 0)
    m2 = float(leg.get("m2") or 0.0)
    if n >= 2 and m2 >= 0:
        band = max(band, sigmas * (m2 / (n - 1)) ** 0.5)
    return band


class DegradeDetector:
    """Per-capture device-time regression detection on the noise band: a
    Welford aggregate per cost fingerprint (fed by ``device_exec``), and
    once ``min_samples`` have landed, a dispatch whose duration exceeds
    ``mean + band`` arms the detector.  The watchdog polls :meth:`degraded`
    each tick and triggers a capture (cooldown-gated) when armed."""

    def __init__(self, sigmas: Optional[float] = None, min_rel: Optional[float] = None,
                 min_abs_us: Optional[float] = None, min_samples: Optional[int] = None,
                 alpha: float = 0.2):
        self.sigmas = sigmas if sigmas is not None else _conf_float("profile_sigmas", 3.0)
        self.min_rel = min_rel if min_rel is not None else _conf_float("profile_min_rel", 0.10)
        self.min_abs_us = min_abs_us if min_abs_us is not None \
            else _conf_float("profile_min_abs_us", 50.0)
        self.min_samples = min_samples if min_samples is not None \
            else _conf_int("profile_min_samples", 32)
        self.alpha = alpha
        self._lock = threading.Lock()
        self._stats: Dict[str, _LegStat] = {}
        self._armed: Optional[str] = None
        self.verdicts = 0

    def on_device_exec(self, pipeline_name, node_name, device, t0_ns, dur_ns, info) -> None:
        del pipeline_name, device, t0_ns
        key = (info or {}).get("cost_key") or f"node:{node_name}"
        dur_us = dur_ns / 1e3
        with self._lock:
            stat = self._stats.get(key)
            if stat is None:
                stat = self._stats[key] = _LegStat()
            if stat.count >= self.min_samples:
                band = _leg_band_us(stat.snapshot(), sigmas=self.sigmas, min_rel=self.min_rel,
                                    min_abs_us=self.min_abs_us)
                if dur_us > stat.mean_us + band:
                    self.verdicts += 1
                    self._armed = (f"{key}: {dur_us:.0f}µs vs mean {stat.mean_us:.0f}µs + "
                                   f"band {band:.0f}µs")
            stat.add(dur_us, self.alpha)

    def degraded(self, clear: bool = True) -> Optional[str]:
        """The armed verdict (cleared on read by default), or None."""
        with self._lock:
            armed = self._armed
            if clear:
                self._armed = None
            return armed


# -- the stats provider ---------------------------------------------------------

def stats() -> dict:
    """The lane's own summary: the gallery, the active and the last capture,
    and the memory ledger's totals."""
    out: dict = {"gallery": gallery().summary()}
    active = active_capture()
    if active:
        out["active"] = active
    last = last_capture()
    if last:
        out["last_capture"] = {k: last.get(k) for k in ("capture_id", "trigger", "parser",
                                                       "ops_total", "seconds", "aborted",
                                                       "pipeline")}
    ledger = hbm_ledger()
    if ledger:
        out["hbm"] = {"resident_estimate_bytes": ledger["resident_estimate_bytes"],
                      "largest_resident": ledger["largest_resident"],
                      "executables": len(ledger["executables"])}
    return out


# the memory gauges ride the default registry from import time: a process
# that captures a graph exposes its footprint on the next scrape
register_hbm_gauges(REGISTRY)
