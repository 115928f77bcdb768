"""Persistent kernel autotune cache: tune once a card, not once a process.

The port's copy of the JAX package's ``ops/autotune.py``, retargeted at the
hand-written CUDA ``int8_matmul`` (``csrc/int8_matmul.cu``).  TVM's
discipline: **search offline, serve from the cache**.

- Winners are keyed by ``(shapes, dtype, card)`` (:func:`make_key`), the
  card named by ``torch.cuda.get_device_name``: a winner timed on one GPU
  model never steers another.  They are stored as JSON under
  ``<[compile] cache_dir>/autotune/<kernel>.json``, one file a kernel,
  rewritten whole and atomically, read once a process (:func:`refresh`
  drops the tables, for tests and cross-process pickup).
- :func:`cached_int8_geometry` is the consult:
  :func:`~nnstreamer_tpu_torch.ops.kernels.int8_matmul_geometry` calls it
  for a call on a card, and a shape's answer is kept in memory after its
  first lookup, so a call does no file I/O.
- :func:`autotune_int8_matmul` searches, on the card, what the kernel can
  launch at a shape: the tiled branch, and the split-K cluster branch at
  each cluster size of :data:`~nnstreamer_tpu_torch.ops.kernels.SPLITS`
  (each with the least ``k_per_rank`` that covers K; above ``SMALL_M``
  rows the split-K branch takes the rows in chunks).  Every candidate
  accumulates in int32, so all must give bitwise the same output as the
  plain version: that is checked, and a candidate that differs raises.  It
  times each (a CUDA graph of back-to-back launches, its replays timed by
  CUDA events) and records the fastest.  It refuses CPU
  tensors, as the JAX package refuses interpret mode: host timings would
  poison the cache.

Conf: ``[compile] autotune`` (default on) gates the consult; ``[compile]
cache_dir`` ("" = off) locates the store.  With no cache dir, or no entry
for a shape, the kernel keeps its static geometry (``SPLIT_K``,
``SMALL_M``).  This is not the tensor-core branch for large M.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_LOG = logging.getLogger("nnstreamer_tpu_torch.ops")

_lock = threading.Lock()
# kernel name -> {key: entry}; absent = not loaded yet for that kernel
_mem: Dict[str, Dict[str, dict]] = {}
# (m, k, n, card) -> the geometry the consult answered (None: the default)
_resolved: Dict[Tuple[int, int, int, str], object] = {}


def _root() -> str:
    from ..conf import conf

    return conf.get_path("compile", "cache_dir", "")


def enabled() -> bool:
    from ..conf import conf

    return bool(_root()) and conf.get_bool("compile", "autotune", True)


def _path(kernel: str) -> str:
    return os.path.join(_root(), "autotune", f"{kernel}.json")


def card_name(device=None) -> str:
    """The GPU model a timing ran on (``torch.cuda.get_device_name``)."""
    import torch

    return torch.cuda.get_device_name(device)


def make_key(shapes, dtype, card: Optional[str] = None) -> str:
    """Canonical cache key: shapes like ``((m, k), (k, n))``, the operand
    dtype, and the GPU model the timing ran on (default: card 0's)."""
    shp = "x".join("_".join(str(d) for d in s) for s in shapes)
    return f"{shp}|{dtype}|{card if card is not None else card_name()}"


def _load(kernel: str) -> Dict[str, dict]:
    with _lock:
        cached = _mem.get(kernel)
        if cached is not None:
            return cached
    table: Dict[str, dict] = {}
    try:
        with open(_path(kernel), "rb") as f:
            raw = json.loads(f.read().decode("utf-8"))
        if isinstance(raw, dict):
            table = {str(k): v for k, v in raw.items() if isinstance(v, dict)}
    except (OSError, ValueError):
        # absent or corrupted: the static geometry serves; the next
        # record() rewrites the file whole
        table = {}
    with _lock:
        _mem[kernel] = table
    return table


def refresh() -> None:
    """Drop the in-memory tables and answers (tests; cross-process pickup)."""
    with _lock:
        _mem.clear()
        _resolved.clear()


def best(kernel: str, key: str) -> Optional[dict]:
    """The winning config entry for ``key``, or None."""
    if not enabled():
        return None
    return _load(kernel).get(key)


def record(kernel: str, key: str, config: dict,
           metric_ms: Optional[float] = None) -> bool:
    """Persist one winner (an atomic rewrite of the whole file)."""
    root = _root()
    if not root:
        return False
    table = dict(_load(kernel))
    entry = dict(config)
    if metric_ms is not None:
        entry["ms"] = round(float(metric_ms), 6)
    entry["recorded_at"] = int(time.time())
    table[key] = entry
    path = _path(kernel)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(table, f, sort_keys=True, indent=1)
        os.replace(tmp, path)
    except OSError as exc:
        _LOG.warning("autotune cache write failed: %r", exc)
        return False
    with _lock:
        _mem[kernel] = table
        _resolved.clear()
    return True


# -- int8_matmul -------------------------------------------------------------

INT8_KERNEL = "int8_matmul"


def int8_key(m: int, k: int, n: int, card: Optional[str] = None) -> str:
    return make_key(((m, k), (k, n)), "int8", card)


def geometry_of(entry: dict, m: int, k: int, n: int):
    """The :class:`~nnstreamer_tpu_torch.ops.kernels.Int8Geometry` a cache
    entry names (``{"branch": "splitk", "split": 4}`` or ``{"branch":
    "tiled"}``), or None for an entry the kernel cannot launch."""
    from . import kernels as K

    branch = entry.get("branch")
    if branch == "tiled":
        return K.tiled_geometry(m, k, n)
    if branch == "splitk":
        try:
            split = int(entry.get("split"))
        except (TypeError, ValueError):
            return None
        if split not in K.SPLITS:
            return None
        return K.splitk_geometry(m, k, n, split)
    return None


def cached_int8_geometry(m: int, k: int, n: int, card: str):
    """The recorded winner's geometry for an ``(m, k) x (k, n)`` call on the
    card named ``card``, or None (the kernel's static geometry).  A shape's
    answer is kept after its first lookup."""
    slot = (int(m), int(k), int(n), str(card))
    with _lock:
        if slot in _resolved:
            return _resolved[slot]
    geo = None
    if enabled():
        entry = _load(INT8_KERNEL).get(int8_key(m, k, n, card))
        if entry:
            geo = geometry_of(entry, m, k, n)
    with _lock:
        _resolved[slot] = geo
    return geo


def int8_candidates(m: int, k: int, n: int) -> List[dict]:
    """What ``csrc/int8_matmul.cu`` can launch at this shape: the split-K
    branch at each cluster size, then the tiled branch."""
    from . import kernels as K

    out = [{"branch": "splitk", "split": s} for s in K.SPLITS
           if -(-n // K.TILE_N) <= K._MAX_GRID_Y]
    return out + [{"branch": "tiled"}]


def _time_ms(torch, fn, reps: int, rounds: int = 5) -> float:
    """Device milliseconds a launch of ``fn``: ``reps`` launches captured in
    one CUDA graph, its replays timed by CUDA events.  A loop of ctypes
    launches would time the host's dispatch (about 20 us a call), not the
    kernel's few microseconds."""
    from ..backends.torch_backend import gc_paused
    from ..obs.launch_gate import launching

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with gc_paused(), torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with launching():
        graph.replay()
    torch.cuda.synchronize()
    begin.record()
    for _ in range(rounds):
        with launching():
            graph.replay()
    end.record()
    end.synchronize()
    return begin.elapsed_time(end) / (rounds * reps)


def autotune_int8_matmul(m: int, k: int, n: int, reps: int = 200, device="cuda",
                         seed: int = 0) -> dict:
    """Search the kernel's launch geometries for one ``(m, k) x (k, n)``
    shape on the card, check each bitwise against the plain version, time
    each (``reps`` launches in a CUDA graph, its replays timed by CUDA
    events: device time, launch gaps included) and record the
    fastest in the cache (when a cache dir is set).  Returns ``{"key",
    "card", "winner", "ms", "recorded", "candidates": [{config, geometry,
    ms, bitwise}]}``.  Refuses a CPU device."""
    import numpy as np
    import torch

    from . import kernels as K

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"autotune_int8_matmul refuses {dev}: a search times the CUDA "
                           "kernel on the card; host timings would poison the cache")
    if not torch.cuda.is_available():
        raise RuntimeError("autotune_int8_matmul needs a CUDA GPU")
    rng = np.random.default_rng(seed)
    x_q = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(dev)
    w_q = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
    x_scale = torch.tensor(np.float32(rng.random() * 0.02 + 1e-3), device=dev)
    w_scale = torch.from_numpy((rng.random(n) * 0.01 + 1e-4).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    want = K.int8_matmul_plain(x_q, w_q, x_scale, w_scale, bias)
    card = card_name(dev)
    rows = []
    for config in int8_candidates(m, k, n):
        geo = geometry_of(config, m, k, n)
        out = torch.full((m, n), float("nan"), dtype=torch.float32, device=dev)
        K.launch_int8_matmul(x_q, w_q, x_scale, w_scale, bias, out, geo)
        torch.cuda.synchronize(dev)
        bitwise = bool(torch.equal(out.view(torch.int32), want.view(torch.int32)))
        if not bitwise:
            raise RuntimeError(
                f"int8_matmul at {geo} differs from the plain version at ({m},{k},{n}): "
                f"max abs diff {float((out - want).abs().max())}")
        ms = _time_ms(torch, lambda g=geo, o=out: K.launch_int8_matmul(
            x_q, w_q, x_scale, w_scale, bias, o, g), reps)
        rows.append({"config": config, "geometry": tuple(geo), "ms": ms, "bitwise": bitwise})
    win = min(rows, key=lambda r: r["ms"])
    key = int8_key(m, k, n, card)
    recorded = record(INT8_KERNEL, key, win["config"], metric_ms=win["ms"])
    return {"key": key, "card": card, "winner": win["config"], "ms": win["ms"],
            "recorded": recorded, "candidates": rows}
