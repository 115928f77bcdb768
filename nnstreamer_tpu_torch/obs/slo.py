"""SLO burn-rate engine: declarative latency objectives, multi-window
burn-rate alerts, evaluated at scrape time over registry histograms.

The Google-SRE multi-window multi-burn-rate recipe, sized to this
runtime: an **objective** declares a latency bound and an error budget
(``target``) over one registry histogram's (optionally label-filtered)
children; the engine reads *windowed bucket deltas* via
:func:`~nnstreamer_tpu_torch.obs.metrics.histogram_deltas` (the one shared
windowed-quantile/delta implementation — the autoscaler and profiling
consume the same helpers) and computes, per window::

    burn = (bad_fraction over window) / (1 - target)

A burn ≥ ``fast_burn`` on the fast window fires at severity ``page``; a
burn ≥ ``slow_burn`` on the slow window alone fires at ``ticket``.  An
alert that stops burning on BOTH windows resolves.  Transitions emit the
``alert`` hook (:mod:`.hooks`), a Perfetto instant when span tracing is
live, and ``nnstpu_slo_alert_transitions_total``; live state is exported
as ``nnstpu_slo_burn_rate{objective,window}`` and
``nnstpu_slo_alerts_firing{objective}`` gauges, served as JSON at the
metrics server's ``/alerts`` endpoint, and folded into ``/healthz`` via
``register_degraded`` (a burning SLO is *degraded*, not unhealthy — the
worker still serves; probes must not amplify an overload into an
outage).  ``obs/collector.py`` merges per-worker ``/alerts`` documents
(the windows carry raw good/total deltas) so the router sees fleet-wide
burn, not N per-worker opinions.

Objective grammar (``[slo] objectives``, semicolon-separated)::

    name:metric{label=value,...}<bound_ms@target

``metric`` defaults to ``nnstpu_e2e_latency_ms``; the label set filters
histogram children (e.g. per pipeline or per tenant).  Example:
``e2e:<50ms@0.999;tenantA:{tenant=A}<25ms@0.99``.  "Good" observations
are counted conservatively from cumulative buckets: the largest bucket
bound ≤ the objective's bound — align bounds with the configured bucket
grid to avoid overcounting bad.

Activation: :func:`ensure_engine` (called by ``MetricsServer.start`` —
any process that scrapes also evaluates) builds the conf-declared
engine as a process singleton; tests construct :class:`SloEngine`
directly with explicit windows and an injected clock.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, List, Optional

from . import hooks
from . import spans as _spans
from .metrics import REGISTRY, MetricsRegistry, histogram_deltas

DEFAULT_METRIC = "nnstpu_e2e_latency_ms"

_OBJ_RE = re.compile(
    r"^(?P<metric>[A-Za-z_:][A-Za-z0-9_:]*)?"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"<(?P<bound>[0-9]+(?:\.[0-9]+)?)ms@(?P<target>[0-9.]+)$"
)


class Objective:
    """One declarative latency objective."""

    __slots__ = ("name", "metric", "labels", "bound_ms", "target")

    def __init__(self, name: str, bound_ms: float, target: float,
                 metric: str = DEFAULT_METRIC,
                 labels: Optional[Dict[str, str]] = None):
        if not (0.0 < target < 1.0):
            raise ValueError(
                f"objective {name!r}: target must be in (0, 1), "
                f"got {target}")
        if bound_ms <= 0:
            raise ValueError(f"objective {name!r}: bound must be positive")
        self.name = name
        self.metric = metric or DEFAULT_METRIC
        self.labels = dict(labels or {})
        self.bound_ms = float(bound_ms)
        self.target = float(target)

    @property
    def budget(self) -> float:
        """The error budget: tolerated bad fraction."""
        return 1.0 - self.target

    def spec(self) -> dict:
        return {"metric": self.metric, "labels": dict(self.labels),
                "bound_ms": self.bound_ms, "target": self.target}


def parse_objectives(spec: str) -> List[Objective]:
    """Parse the ``[slo] objectives`` grammar; raises ``ValueError``
    naming the offending clause."""
    out: List[Objective] = []
    for clause in (spec or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        name, sep, rest = clause.partition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"SLO objective {clause!r}: expected 'name:...<boundms@target'")
        m = _OBJ_RE.match(rest.strip().replace(" ", ""))
        if m is None:
            raise ValueError(
                f"SLO objective {clause!r}: cannot parse "
                f"'{rest.strip()}' (grammar: "
                "[metric][{label=value,...}]<bound_ms@target)")
        labels: Dict[str, str] = {}
        for pair in (m.group("labels") or "").split(","):
            pair = pair.strip()
            if not pair:
                continue
            k, eq, v = pair.partition("=")
            if not eq or not k.strip():
                raise ValueError(
                    f"SLO objective {clause!r}: bad label pair {pair!r}")
            labels[k.strip()] = v.strip()
        out.append(Objective(
            name, float(m.group("bound")), float(m.group("target")),
            metric=m.group("metric") or DEFAULT_METRIC, labels=labels))
    return out


class _State:
    """Per-objective evaluation state."""

    def __init__(self, obj: Objective):
        self.obj = obj
        self.prev: Dict[tuple, list] = {}     # histogram_deltas cursor
        self.ring: List[tuple] = []           # (t, good_delta, total_delta)
        self.state = "ok"
        self.severity = ""
        self.since = 0.0
        self.transitions = 0
        self.windows: Dict[str, dict] = {}


class SloEngine:
    """Evaluate objectives over registry histogram deltas; keep alert
    state; publish gauges, the hook, and the ``/alerts`` document."""

    def __init__(self, objectives=None,
                 registry: Optional[MetricsRegistry] = None,
                 fast_window_s: Optional[float] = None,
                 slow_window_s: Optional[float] = None,
                 fast_burn: Optional[float] = None,
                 slow_burn: Optional[float] = None,
                 eval_interval_s: Optional[float] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        from ..conf import conf

        if objectives is None:
            objectives = conf.get("slo", "objectives", "") or ""
        if isinstance(objectives, str):
            objectives = parse_objectives(objectives)
        self.objectives: List[Objective] = list(objectives)

        def knob(value, key, default):
            if value is not None:
                return float(value)
            try:
                return conf.get_float("slo", key, default)
            except ValueError:
                return default

        self.fast_window_s = knob(fast_window_s, "fast_window_s", 60.0)
        self.slow_window_s = max(
            knob(slow_window_s, "slow_window_s", 600.0), self.fast_window_s)
        self.fast_burn = knob(fast_burn, "fast_burn", 14.0)
        self.slow_burn = knob(slow_burn, "slow_burn", 6.0)
        self.eval_interval_s = knob(eval_interval_s, "eval_interval_s", 5.0)
        self._now = now_fn
        self._registry = registry if registry is not None else REGISTRY
        self._states = [_State(o) for o in self.objectives]
        self._lock = threading.Lock()
        self._last_eval: Optional[float] = None
        self._installed = False
        self._burn_gauge = self._registry.gauge(
            "nnstpu_slo_burn_rate",
            "Error-budget burn rate per objective and window",
            labelnames=("objective", "window"),
        )
        self._firing_gauge = self._registry.gauge(
            "nnstpu_slo_alerts_firing",
            "1 while the objective's burn-rate alert is firing",
            labelnames=("objective",),
        )
        self._transitions = self._registry.counter(
            "nnstpu_slo_alert_transitions_total",
            "SLO alert state transitions (state: firing/resolved)",
            labelnames=("objective", "state"),
        )

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None,
                 force: bool = False) -> None:
        """Advance every objective's windows and alert state.  Rate-
        limited to ``eval_interval_s`` (scrape-time calls are free to be
        frequent); ``force`` bypasses — tests and transitions-on-demand."""
        with self._lock:
            t = self._now() if now is None else float(now)
            if (not force and self._last_eval is not None
                    and t - self._last_eval < self.eval_interval_s):
                return
            self._last_eval = t
            for st in self._states:
                self._eval_one(st, t)

    def _eval_one(self, st: _State, now: float) -> None:
        metric = self._registry.get(st.obj.metric)
        deltas = histogram_deltas(metric, st.prev, st.obj.labels or None)
        good = sum(n for b, n in deltas if b <= st.obj.bound_ms)
        total = sum(n for _b, n in deltas)
        st.ring.append((now, good, total))
        while st.ring and st.ring[0][0] <= now - self.slow_window_s:
            st.ring.pop(0)
        fast = self._window(st, now, self.fast_window_s, self.fast_burn)
        slow = self._window(st, now, self.slow_window_s, self.slow_burn)
        st.windows = {"fast": fast, "slow": slow}
        self._burn_gauge.set(fast["burn"], objective=st.obj.name,
                             window="fast")
        self._burn_gauge.set(slow["burn"], objective=st.obj.name,
                             window="slow")
        fast_hot = fast["burn"] >= self.fast_burn
        firing = fast_hot or slow["burn"] >= self.slow_burn
        severity = "page" if fast_hot else "ticket"
        detail = (f"fast={fast['burn']:.1f}x/{self.fast_window_s:g}s "
                  f"slow={slow['burn']:.1f}x/{self.slow_window_s:g}s "
                  f"bound={st.obj.bound_ms:g}ms target={st.obj.target:g}")
        if firing and st.state != "firing":
            st.state, st.severity, st.since = "firing", severity, now
            st.transitions += 1
            self._transition(st.obj.name, "firing", severity, detail)
        elif firing:
            st.severity = severity  # escalation/de-escalation, no re-alert
        elif st.state == "firing":
            st.state, st.since = "ok", now
            st.transitions += 1
            self._transition(st.obj.name, "resolved", st.severity, detail)
            st.severity = ""
        self._firing_gauge.set(1.0 if st.state == "firing" else 0.0,
                               objective=st.obj.name)

    def _window(self, st: _State, now: float, window_s: float,
                threshold: float) -> dict:
        good = total = 0.0
        for t, g, n in st.ring:
            if t > now - window_s:
                good += g
                total += n
        bad = max(0.0, total - good)
        burn = (bad / total) / st.obj.budget if total else 0.0
        return {"window_s": window_s, "good": good, "total": total,
                "burn": round(burn, 4), "threshold": threshold}

    def _transition(self, name: str, state: str, severity: str,
                    detail: str) -> None:
        self._transitions.inc(objective=name, state=state)
        hooks.emit("alert", name, state, severity, detail)
        if _spans.enabled:
            _spans.record_instant(f"alert:{name}", cat="slo", trace=(0, 0),
                                  args={"state": state, "severity": severity,
                                        "detail": detail})

    # -- documents -----------------------------------------------------------

    def alerts_document(self, refresh: bool = True,
                        now: Optional[float] = None,
                        force: bool = False) -> dict:
        """The ``/alerts`` JSON body.  Per-objective windows carry raw
        good/total deltas so federation (``collector.merge_alerts``) can
        recompute fleet-wide burn from summed counts."""
        if refresh:
            self.evaluate(now=now, force=force)
        objectives: Dict[str, dict] = {}
        firing: List[str] = []
        with self._lock:
            for st in self._states:
                entry = dict(st.obj.spec())
                entry.update(state=st.state, severity=st.severity,
                             transitions=st.transitions,
                             windows=dict(st.windows))
                objectives[st.obj.name] = entry
                if st.state == "firing":
                    firing.append(st.obj.name)
        return {"objectives": objectives, "firing": sorted(firing)}

    def degraded_reason(self) -> str:
        """``register_degraded`` provider: "" while nothing burns."""
        with self._lock:
            burning = [f"slo {st.obj.name} burning"
                       f" ({st.severity or 'ticket'},"
                       f" fast {st.windows.get('fast', {}).get('burn', 0):g}x)"
                       for st in self._states if st.state == "firing"]
        return "; ".join(burning)

    # -- lifecycle -----------------------------------------------------------

    def install(self) -> "SloEngine":
        """Wire into the scrape path: a registry collector evaluates at
        every scrape (rate-limited), ``/healthz`` shows burning SLOs as
        degraded, and ``/alerts`` serves this engine's document."""
        if self._installed:
            return self
        from . import export

        # bind once: unregister matches by identity
        self._collect_fn = self._registry.add_collector(
            lambda: self.evaluate())
        self._degraded_fn = export.register_degraded(
            "slo", self.degraded_reason)
        self._alerts_fn = export.register_alerts(self.alerts_document)
        self._installed = True
        global _engine
        _engine = self
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        from . import export

        self._registry.remove_collector(self._collect_fn)
        export.unregister_degraded("slo", self._degraded_fn)
        export.unregister_alerts(self._alerts_fn)
        self._installed = False
        global _engine
        if _engine is self:
            _engine = None


# -- process singleton --------------------------------------------------------

_engine: Optional[SloEngine] = None
_ensure_lock = threading.Lock()


def current_engine() -> Optional[SloEngine]:
    return _engine


def ensure_engine(registry: Optional[MetricsRegistry] = None
                  ) -> Optional[SloEngine]:
    """Build + install the conf-declared engine once per process; None
    when ``[slo] objectives`` is empty.  A malformed spec logs and
    disables — observability must not take the process down."""
    global _engine
    with _ensure_lock:
        if _engine is not None:
            return _engine
        from ..conf import conf

        spec = conf.get("slo", "objectives", "") or ""
        if not spec.strip():
            return None
        try:
            return SloEngine(objectives=spec, registry=registry).install()
        except Exception:  # noqa: BLE001
            import logging

            logging.getLogger("nnstreamer_tpu_torch.obs").exception(
                "SLO engine disabled: bad [slo] objectives spec %r", spec)
            return None


def reset() -> None:
    """Uninstall the singleton (test isolation)."""
    with _ensure_lock:
        if _engine is not None:
            _engine.uninstall()
