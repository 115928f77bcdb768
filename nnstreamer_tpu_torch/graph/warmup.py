"""The warmup phase: capture every geometry the stream will bring before
PLAYING.

The port of the JAX package's ``graph/warmup.py``.  Negotiation captures
each filter's negotiated geometry (``backends/torch_backend.py``); an
element that widens the set at run time, ``tensor_dynbatch`` with its
bucket ladder, plans the rest (:meth:`~nnstreamer_tpu_torch.graph.node.Node.warmup_plan`),
and :func:`run_warmup` captures them inside ``Pipeline.start``, after
negotiation and before any source or queue thread runs.  A pile-up's first
flip to a new bucket then replays a graph captured in advance instead of
capturing one on the stream's path.

Two CUDA graph captures must not run at once on one device (a capture
synchronizes the device and claims its streams), so :func:`execute` runs
the plan's captures one at a time, in plan order, where the JAX package
compiles on a pool of ``[compile] warmup_workers`` threads; the port has
no such knob, and its report says ``workers: 1``.  A capture that fails
fails the start, as a failed capture in negotiation does; ``[compile] warmup_timeout_s`` bounds
the whole phase, checked after each capture.

Progress is observable: the ``warmup`` hook fires per capture and once at
the end, ``nnstpu_warmup_seconds{pipeline}`` (the port's metrics registry)
records the phase's wall time, and with the ``spans`` tracer on each
capture and the whole phase are spans on a ``warmup`` track.

Activation: ``[compile] warmup`` (``NNSTPU_COMPILE_WARMUP=1``; off by
default, so a short-lived pipeline does not capture buckets it never
sees), or :meth:`Pipeline.warmup` explicitly.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, List, Optional, Tuple

from ..obs import hooks as _hooks
from ..obs import spans as _spans

# one item of work: (node name, label, capture thunk)
WarmupItem = Tuple[str, str, Callable[[], object]]

WARMUP_BUCKETS_S = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)


def configured() -> bool:
    from ..conf import conf

    return conf.get_bool("compile", "warmup", False)


def configured_timeout_s() -> float:
    from ..conf import conf

    try:
        return conf.get_float("compile", "warmup_timeout_s", 600.0)
    except ValueError:
        return 600.0


def collect_plan(pipeline) -> List[WarmupItem]:
    """Every node's warmup plan, in node order.  A node whose planning
    raises is left out with a warning: its geometries are then captured
    when their first frame comes, as without warmup."""
    items: List[WarmupItem] = []
    for node in pipeline.nodes.values():
        plan = getattr(node, "warmup_plan", None)
        if plan is None:
            continue
        try:
            for label, thunk in plan():
                items.append((node.name, label, thunk))
        except Exception as exc:  # noqa: BLE001 - planning never fails a start
            warnings.warn(f"warmup plan for {node.name!r} failed: {exc!r}; its geometries "
                          "will be captured when their first frame comes", stacklevel=2)
    return items


def execute(items: List[WarmupItem], pipeline=None, timeout_s: Optional[float] = None,
            name: str = "") -> dict:
    """Run the capture thunks one at a time; the first error propagates.
    Returns the report: the pipeline, the item count, each capture's node,
    label and seconds, the phase's seconds and ``workers`` (always 1)."""
    from ..obs.metrics import REGISTRY

    pname = name or (pipeline.name if pipeline is not None else "")
    deadline = configured_timeout_s() if timeout_s is None else timeout_s
    t_phase = time.perf_counter_ns()
    total = len(items)
    report = {"pipeline": pname, "items": total, "compiled": [], "seconds": 0.0,
              "workers": 1}
    for done, (node_name, label, thunk) in enumerate(items, 1):
        t0 = time.perf_counter_ns()
        thunk()
        dur = time.perf_counter_ns() - t0
        report["compiled"].append({"node": node_name, "label": label, "seconds": dur / 1e9})
        if _spans.enabled:
            _spans.record_span(f"warm:{node_name}:{label}", t0, dur, cat="warmup",
                               args={"node": node_name, "label": label})
        if _hooks.enabled:
            _hooks.emit("warmup", pipeline, node_name, label, done, total, dur)
        if deadline and (time.perf_counter_ns() - t_phase) / 1e9 > deadline and done < total:
            raise TimeoutError(f"warmup of {pname!r} passed {deadline} s after {done} of "
                               f"{total} captures")
    phase_ns = time.perf_counter_ns() - t_phase
    report["seconds"] = phase_ns / 1e9
    REGISTRY.histogram("nnstpu_warmup_seconds", "Warmup phase wall time (seconds)",
                       labelnames=("pipeline",), buckets=WARMUP_BUCKETS_S,
                       ).observe(phase_ns / 1e9, pipeline=pname)
    if _spans.enabled:
        _spans.record_span("warmup", t_phase, phase_ns, cat="warmup",
                           args={"pipeline": pname, "executables": total})
    if _hooks.enabled:
        _hooks.emit("warmup", pipeline, "", "", total, total, phase_ns)
    return report


def check_memory(pipeline) -> dict:
    """The captured graphs' memory against the card, after the captures
    (``obs/profiler.py`` :func:`~..obs.profiler.check_hbm_capacity`):
    over capacity is a typed ``HbmCapacityWarning`` and a degraded reason
    on ``/healthz`` before PLAYING, never a start failure.  A check that
    fails itself says why in the report."""
    from ..obs.profiler import check_hbm_capacity

    try:
        return check_hbm_capacity(pipeline)
    except Exception as exc:  # noqa: BLE001 - the residency check is advisory
        return {"error": repr(exc)}


def run_warmup(pipeline, force: bool = False) -> Optional[dict]:
    """``Pipeline.start``'s call: nothing unless ``[compile] warmup`` is on
    (or ``force``); else collect and execute the plan, check the captured
    graphs' memory (``report["hbm"]``, :func:`check_memory`) and keep the
    report as ``pipeline.warmup_report``."""
    if not force and not configured():
        return None
    report = execute(collect_plan(pipeline), pipeline=pipeline)
    report["hbm"] = check_memory(pipeline)
    pipeline.warmup_report = report
    return report
