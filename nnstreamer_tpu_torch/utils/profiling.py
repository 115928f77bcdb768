"""Per-node timing.

The port's copy of the JAX package's ``utils/profiling.py``: a
process-global registry of per-node invoke latencies, toggled at runtime
(``enable``, ``profiled``, or ``[common] enable_profiling`` read at
``Pipeline.start``).  ``tensor_filter`` times ``backend.invoke`` plus
:func:`block_outputs` and :func:`record`\\ s it under the filter's name;
``Pipeline.stats`` reads the summary back.

Recorded invoke latencies are also folded into the metrics registry
(:mod:`nnstreamer_tpu_torch.obs.metrics`) as the
``nnstpu_node_invoke_latency_ms`` histogram, so enabling profiling makes
per-node latencies scrapeable from the Prometheus endpoint.

Not ported yet: ``device_trace`` (a whole-device trace of a region, which
the port would take with ``torch.profiler``; it waits for
``obs/profiler.py``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Sequence

import torch

_enabled = False
_lock = threading.Lock()
_records: Dict[str, List[int]] = {}


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def record(node_name: str, duration_ns: int) -> None:
    with _lock:
        _records.setdefault(node_name, []).append(duration_ns)
    # get-or-create is idempotent, so this survives registry resets
    from ..obs.metrics import REGISTRY

    REGISTRY.histogram(
        "nnstpu_node_invoke_latency_ms",
        "Per-node invoke latency (milliseconds), recorded while profiling "
        "is enabled",
        labelnames=("node",),
    ).observe(duration_ns / 1e6, node=node_name)


def block_outputs(outs) -> None:
    """Wait until the device work that produced ``outs`` is done, so that a
    recorded time covers it and not only its enqueue.

    The backend replays its CUDA graph and clones the outputs on the
    filter thread's current stream: an event recorded there now follows
    that work, and waiting on the event waits for it alone.  Never
    ``torch.cuda.synchronize()``: that waits for the whole device, the
    upload's side-stream copies of later frames included.  A CPU tensor
    is done when it is returned."""
    seen = set()
    for o in outs:
        if not isinstance(o, torch.Tensor) or not o.is_cuda or o.device in seen:
            continue
        seen.add(o.device)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(o.device))
        done.synchronize()


def summarize_ns(ns: Sequence[int]) -> Dict[str, float]:
    """Latency summary (ms) of a sample of nanosecond durations.

    Percentiles use **ceil-based nearest rank** — ``s[ceil(q*n) - 1]`` —
    so p99 is the smallest value ≥ 99% of the sample.
    """
    from ..obs.metrics import quantile_rank

    s = sorted(ns)
    n = len(s)
    return {
        "count": n,
        "mean_ms": sum(s) / n / 1e6,
        "p50_ms": quantile_rank(s, 0.50) / 1e6,
        "p90_ms": quantile_rank(s, 0.90) / 1e6,
        "p99_ms": quantile_rank(s, 0.99) / 1e6,
        "min_ms": s[0] / 1e6,
        "max_ms": s[-1] / 1e6,
    }


def stats() -> Dict[str, Dict[str, float]]:
    """Per-node latency summary in milliseconds."""
    with _lock:
        snap = {name: list(ns) for name, ns in _records.items() if ns}
    return {name: summarize_ns(ns) for name, ns in snap.items()}


def reset() -> None:
    with _lock:
        _records.clear()


@contextlib.contextmanager
def profiled():
    """Context manager: enable, yield, restore."""
    prev = _enabled
    enable(True)
    try:
        yield
    finally:
        enable(prev)
