"""SLO-driven fleet autoscaling: a control loop over signals the fleet
already publishes.

The port of the JAX package's ``fleet/autoscaler.py``: the same plan from
the same :class:`FleetSignals` at the same ``now``, and the same scale
events.  :class:`RouterSignals` reads the busy fraction from the port's
device lane (``obs/device.py``'s ``nnstpu_device_busy_fraction``, the share
of its window the card spent in observed dispatches, timed by CUDA events).

The TVM lesson (measure → act) applied to capacity: the fleet tier has
published per-worker queue-wait p99 (``nnstpu_sched_queue_wait_ms``),
typed shed rates (the router's exact ledger), device utilization
(``nnstpu_device_busy_fraction``) and membership health — this module
closes the loop.  :class:`Autoscaler` reads one
:class:`FleetSignals` snapshot per tick and steers a
:class:`~.supervisor.Supervisor` toward the worker count the SLO needs:
spawning **ahead** of load (the predictive leg forecasts the offered-
load history, so a diurnal ramp scales up before the queue-wait SLO
burns) and SIGTERM-draining on the down-slope (migrate-first for
session-hosting workers via the surface routers, warming-gated before a
spawn is routable).

The robustness core — what keeps a noisy signal from oscillating or
wedging the fleet:

- **hysteresis bands**: scale up above ``queue_wait_hi_ms`` /
  ``busy_hi`` / ``shed_hi``, down only below ``queue_wait_lo_ms`` +
  ``busy_lo`` with zero shed; the dead band between them absorbs noise;
- **per-direction cooldowns** (``up_cooldown_s`` / ``down_cooldown_s``)
  so one burst cannot chain actions faster than their effects land;
- **flap damping**: ``flap_limit`` direction reversals inside
  ``flap_window_s`` freeze scaling (a ``flap_damped`` event carries the
  WHY) until the window drains — the seeded ``scale_flap`` chaos kind
  drives exactly this and the fleet must hold steady;
- **a scale-storm budget**: at most ``storm_budget`` spawns per
  ``storm_window_s``; past it the controller *escalates* — a typed
  degraded ``/healthz`` reason (``obs.export.register_degraded``) and a
  ``storm`` event — instead of forking unboundedly;
- **supervised respawn + crash-loop quarantine** ride along on the
  supervisor's tick (capped backoff, hold-down with the WHY in
  ``stats()``), so a crashed worker heals without operator action and a
  crash-looping one cannot eat the budget.

Everything lands in one place: ``nnstpu_autoscale_events_total
{action}``, the ``nnstpu_autoscale_workers{state}`` /
``nnstpu_autoscale_forecast_rps`` gauges, the ``scale_event`` hook,
``scale:<action>`` Perfetto instants, and ``stats()`` (registered as
``autoscale:<name>``) whose spawn ledger is exact:
``spawns == joined + failed + quarantined + cancelled (+ pending)``.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from .. import faults as _faults
from .supervisor import ScaleEventLog, Supervisor


class FleetSignals:
    """One tick's snapshot of the fleet's federated SLO signals."""

    __slots__ = ("queue_wait_p99_ms", "shed_rate", "busy", "offered_rps",
                 "workers_up", "per_worker")

    def __init__(self, queue_wait_p99_ms: float = 0.0,
                 shed_rate: float = 0.0, busy: float = 0.0,
                 offered_rps: float = 0.0, workers_up: int = 0,
                 per_worker: Optional[dict] = None):
        self.queue_wait_p99_ms = float(queue_wait_p99_ms)
        self.shed_rate = float(shed_rate)
        self.busy = float(busy)
        self.offered_rps = float(offered_rps)
        self.workers_up = int(workers_up)
        self.per_worker = per_worker or {}

    def snapshot(self) -> dict:
        return {
            "queue_wait_p99_ms": self.queue_wait_p99_ms,
            "shed_rate": self.shed_rate,
            "busy": self.busy,
            "offered_rps": self.offered_rps,
            "workers_up": self.workers_up,
        }


def _hist_p99(metric, prev: Dict[tuple, list],
              label_filter: Optional[Dict[str, str]] = None) -> float:
    """p99 (ms) of a registry histogram's growth since the last call —
    the *windowed* tail, not the lifetime one, which is what a control
    loop must react to.  ``prev`` holds per-child cumulative baselines
    across calls."""
    from ..obs.metrics import histogram_deltas, histogram_quantile

    deltas = histogram_deltas(metric, prev, label_filter)
    return histogram_quantile(0.99, deltas, inf_value=1e9, empty_value=0.0)


class RouterSignals:
    """Build :class:`FleetSignals` from a live router + membership (+
    the metrics registry): offered/shed rates from the router ledger's
    growth per tick, queue-wait p99 from the front-door scheduler's
    histogram window, busy fraction from the device gauges."""

    def __init__(self, router, membership, registry=None,
                 clock: Callable[[], float] = time.monotonic):
        if registry is None:
            from ..obs.metrics import REGISTRY

            registry = REGISTRY
        self.router = router
        self.membership = membership
        self._registry = registry
        self._clock = clock
        self._last_t: Optional[float] = None
        self._last_offered = 0
        self._last_shed = 0
        self._hist_prev: Dict[tuple, list] = {}

    def __call__(self) -> FleetSignals:
        from .membership import DEGRADED, UP

        now = self._clock()
        st = self.router.stats()
        offered, shed = st["offered"], st["shed_total"]
        dt = (now - self._last_t) if self._last_t is not None else 0.0
        d_offered = offered - self._last_offered
        d_shed = shed - self._last_shed
        self._last_t, self._last_offered, self._last_shed = \
            now, offered, shed
        offered_rps = d_offered / dt if dt > 0 else 0.0
        shed_rate = d_shed / d_offered if d_offered > 0 else 0.0
        sched = getattr(self.router, "scheduler", None)
        qw = _hist_p99(
            self._registry.get("nnstpu_sched_queue_wait_ms"),
            self._hist_prev,
            {"server": sched.name} if sched is not None else None)
        busy_metric = self._registry.get("nnstpu_device_busy_fraction")
        busy = 0.0
        if busy_metric is not None:
            vals = [child.value for _k, child in busy_metric.children()]
            busy = sum(vals) / len(vals) if vals else 0.0
        workers_up = sum(1 for w in self.membership.workers()
                         if w.state in (UP, DEGRADED) and not w.draining)
        return FleetSignals(
            queue_wait_p99_ms=qw, shed_rate=shed_rate, busy=busy,
            offered_rps=offered_rps, workers_up=workers_up,
            per_worker={w.id: w.state for w in self.membership.workers()})


class Autoscaler:
    """The control loop: one :meth:`tick` reads signals, plans a desired
    worker count through the hysteresis/cooldown/damping/storm gauntlet,
    and applies it through the supervisor.  :meth:`start` runs ticks on
    a daemon thread every ``[autoscale] interval_s``; tests drive
    :meth:`tick` directly (pass a fake ``clock`` for determinism)."""

    def __init__(self, supervisor: Supervisor,
                 signals: Callable[[], FleetSignals],
                 name: str = "autoscaler",
                 clock: Callable[[], float] = time.monotonic,
                 registry=None, sweep: bool = True,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 interval_s: Optional[float] = None,
                 queue_wait_hi_ms: Optional[float] = None,
                 queue_wait_lo_ms: Optional[float] = None,
                 busy_hi: Optional[float] = None,
                 busy_lo: Optional[float] = None,
                 shed_hi: Optional[float] = None,
                 up_cooldown_s: Optional[float] = None,
                 down_cooldown_s: Optional[float] = None,
                 flap_window_s: Optional[float] = None,
                 flap_limit: Optional[int] = None,
                 storm_budget: Optional[int] = None,
                 storm_window_s: Optional[float] = None,
                 forecast: Optional[bool] = None,
                 forecast_horizon_s: Optional[float] = None,
                 history_window_s: Optional[float] = None,
                 worker_rps: Optional[float] = None):
        from ..conf import conf

        def _f(key, arg, default):
            return float(arg) if arg is not None else \
                conf.get_float("autoscale", key, default)

        def _i(key, arg, default):
            return int(arg) if arg is not None else \
                conf.get_int("autoscale", key, default)

        self.supervisor = supervisor
        self.signals = signals
        self.name = str(name)
        self._clock = clock
        self.sweep = bool(sweep)
        self.min_workers = _i("min_workers", min_workers, 1)
        self.max_workers = _i("max_workers", max_workers, 4)
        self.interval_s = _f("interval_s", interval_s, 0.5)
        self.queue_wait_hi_ms = _f("queue_wait_hi_ms", queue_wait_hi_ms, 50.0)
        self.queue_wait_lo_ms = _f("queue_wait_lo_ms", queue_wait_lo_ms, 5.0)
        self.busy_hi = _f("busy_hi", busy_hi, 0.85)
        self.busy_lo = _f("busy_lo", busy_lo, 0.20)
        self.shed_hi = _f("shed_hi", shed_hi, 0.01)
        self.up_cooldown_s = _f("up_cooldown_s", up_cooldown_s, 1.0)
        self.down_cooldown_s = _f("down_cooldown_s", down_cooldown_s, 5.0)
        self.flap_window_s = _f("flap_window_s", flap_window_s, 30.0)
        self.flap_limit = _i("flap_limit", flap_limit, 3)
        self.storm_budget = _i("storm_budget", storm_budget, 6)
        self.storm_window_s = _f("storm_window_s", storm_window_s, 30.0)
        self.forecast_enabled = (bool(forecast) if forecast is not None
                                 else conf.get_bool("autoscale", "forecast",
                                                    True))
        self.forecast_horizon_s = _f(
            "forecast_horizon_s", forecast_horizon_s, 5.0)
        self.history_window_s = _f("history_window_s", history_window_s, 60.0)
        self.worker_rps = _f("worker_rps", worker_rps, 0.0)
        self.events = supervisor.events if isinstance(
            supervisor.events, ScaleEventLog) else ScaleEventLog(self.name)
        self._lock = threading.Lock()
        self._history: deque = deque()       # (t, offered_rps)
        self._spawn_times: deque = deque()   # storm-budget window
        self._actions: deque = deque()       # (t, direction) applied
        self._last_up = -1e18
        self._last_down = -1e18
        self._damped = False
        self._storm_reason = ""
        self._flap_sign = 1                  # scale_flap chaos toggle
        self._last_forecast = 0.0
        self._last_signals: Optional[FleetSignals] = None
        self._last_decision = ""
        self.ticks = 0
        self.fleet_size_min: Optional[int] = None
        self.fleet_size_max: Optional[int] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is None:
            from ..obs.metrics import REGISTRY

            registry = REGISTRY
        self._g_workers = registry.gauge(
            "nnstpu_autoscale_workers",
            "fleet worker counts by state (desired / ready / joining / "
            "quarantined)", labelnames=("state",))
        self._g_forecast = registry.gauge(
            "nnstpu_autoscale_forecast_rps",
            "offered-load forecast at now + forecast_horizon_s")
        from ..obs.export import register_degraded, register_stats

        register_degraded(f"autoscale:{self.name}",
                          lambda: self._storm_reason)
        register_stats(f"autoscale:{self.name}", self.stats)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Autoscaler":
        _faults.ensure_configured()  # chaos covers the control loop too
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"autoscale:{self.name}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        from ..obs.export import unregister_degraded, unregister_stats

        unregister_degraded(f"autoscale:{self.name}")
        unregister_stats(f"autoscale:{self.name}")

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                import logging

                logging.getLogger("nnstreamer_tpu_torch.fleet").exception(
                    "%s: autoscaler tick failed", self.name)

    # -- the control loop -----------------------------------------------------

    def tick(self) -> None:
        """One pass: sweep → supervise → read signals → plan → apply."""
        now = self._clock()
        self.ticks += 1
        if self.sweep:
            for s in self.supervisor.surfaces:
                try:
                    s.membership.sweep()
                except Exception:  # noqa: BLE001 — a sick probe != no tick
                    pass
        self.supervisor.tick()
        sig = self.signals()
        self._last_signals = sig
        with self._lock:
            self._history.append((now, sig.offered_rps))
            while self._history and \
                    self._history[0][0] < now - self.history_window_s:
                self._history.popleft()
        cur = self.supervisor.worker_count()
        self._observe_fleet(cur)
        raw, why = self._plan(sig, cur, now)
        self._apply(raw, cur, now, why)
        self._publish(raw)

    def _observe_fleet(self, cur: int) -> None:
        if self.fleet_size_min is None or cur < self.fleet_size_min:
            self.fleet_size_min = cur
        if self.fleet_size_max is None or cur > self.fleet_size_max:
            self.fleet_size_max = cur

    # -- planning -------------------------------------------------------------

    def forecast(self, now: Optional[float] = None) -> float:
        """Least-squares linear forecast of offered rps at ``now +
        forecast_horizon_s`` over the retained history (the diurnal
        profile is locally linear at control-loop timescales)."""
        with self._lock:
            pts = list(self._history)
        if len(pts) < 3 or pts[-1][0] - pts[0][0] < self.forecast_horizon_s:
            # too little history to extrapolate a slope honestly: hold
            # the last observation instead of amplifying startup noise
            return pts[-1][1] if pts else 0.0
        t0 = pts[0][0]
        xs = [t - t0 for t, _ in pts]
        ys = [r for _, r in pts]
        n = len(xs)
        mx, my = sum(xs) / n, sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den
                 if den > 0 else 0.0)
        now = self._clock() if now is None else now
        horizon_x = (now - t0) + self.forecast_horizon_s
        return max(0.0, my + slope * (horizon_x - mx))

    def _plan(self, sig: FleetSignals, cur: int, now: float):
        """Raw desired worker count + the reason — BEFORE cooldown/
        damping/storm gating (those are applied in :meth:`_apply`)."""
        raw, why = cur, ""
        # reactive band: any burning signal asks for one more worker
        if sig.queue_wait_p99_ms > self.queue_wait_hi_ms:
            raw, why = cur + 1, (f"queue_wait p99 {sig.queue_wait_p99_ms:.1f}"
                                 f"ms > {self.queue_wait_hi_ms:g}ms")
        elif sig.shed_rate > self.shed_hi:
            raw, why = cur + 1, (f"shed rate {sig.shed_rate:.3f} > "
                                 f"{self.shed_hi:g}")
        elif sig.busy > self.busy_hi:
            raw, why = cur + 1, (f"busy {sig.busy:.2f} > {self.busy_hi:g}")
        # demand leg: the measured offered load vs per-worker capacity —
        # a spike that outruns the fleet staffs up NOW, without waiting
        # for queue-wait to burn through the reactive band
        need_now = (math.ceil(sig.offered_rps / self.worker_rps)
                    if self.worker_rps > 0 else 0)
        if need_now > raw:
            raw, why = need_now, (
                f"load {sig.offered_rps:.1f} rps needs {need_now} x "
                f"{self.worker_rps:g} rps workers")
        # predictive leg: forecast the diurnal profile and staff for it
        # BEFORE the reactive signals burn
        need_fc = 0
        if self.forecast_enabled and self.worker_rps > 0:
            self._last_forecast = self.forecast(now)
            need_fc = math.ceil(self._last_forecast / self.worker_rps) \
                if self._last_forecast > 0 else 0
            if need_fc > raw:
                raw, why = need_fc, (
                    f"forecast {self._last_forecast:.1f} rps needs "
                    f"{need_fc} x {self.worker_rps:g} rps workers")
        # scale-down: ONLY when every signal sits below the low band and
        # neither the current load nor the forecast needs this worker
        if raw == cur and cur > self.min_workers \
                and sig.queue_wait_p99_ms < self.queue_wait_lo_ms \
                and sig.shed_rate <= 0.0 and sig.busy < self.busy_lo:
            if max(need_now, need_fc) < cur:
                raw, why = cur - 1, (
                    f"idle: queue_wait {sig.queue_wait_p99_ms:.1f}ms < "
                    f"{self.queue_wait_lo_ms:g}ms, busy {sig.busy:.2f}, "
                    f"load needs {max(need_now, need_fc)}")
        # chaos: a firing scale_flap rule perturbs the raw plan with an
        # alternating bias — the damper below must hold the fleet steady
        if _faults.enabled:
            rule = _faults.maybe_scale_flap(f"{self.name}:plan")
            if rule is not None:
                self._flap_sign = -self._flap_sign
                raw, why = raw + self._flap_sign, (
                    f"injected scale_flap bias {self._flap_sign:+d} "
                    f"(opportunity {rule.opportunities})")
        return max(self.min_workers, min(self.max_workers, raw)), why

    # -- applying -------------------------------------------------------------

    def _flapping(self, now: float) -> bool:
        """Reversal counting over the applied-action history."""
        with self._lock:
            while self._actions and \
                    self._actions[0][0] < now - self.flap_window_s:
                self._actions.popleft()
            reversals = sum(
                1 for i in range(1, len(self._actions))
                if self._actions[i][1] != self._actions[i - 1][1])
        return reversals >= self.flap_limit

    def _storm_spent(self, now: float) -> int:
        with self._lock:
            while self._spawn_times and \
                    self._spawn_times[0] < now - self.storm_window_s:
                self._spawn_times.popleft()
            return len(self._spawn_times)

    def _apply(self, desired: int, cur: int, now: float, why: str) -> None:
        delta = desired - cur
        self._last_decision = (f"desired={desired} current={cur}"
                               + (f" ({why})" if why else ""))
        if delta == 0:
            if not self._flapping(now):
                self._damped = False
            return
        # flap damping: too many direction reversals recently — hold the
        # fleet steady until the window drains, whatever the plan says
        if self._flapping(now):
            if not self._damped:
                self._damped = True
                self.events.emit(
                    "flap_damped", "",
                    f"{self.flap_limit}+ direction reversals within "
                    f"{self.flap_window_s:g}s; holding at {cur} "
                    f"(wanted {desired}: {why})", fleet=cur)
            return
        self._damped = False
        if delta > 0:
            if now - self._last_up < self.up_cooldown_s:
                return
            spent = self._storm_spent(now)
            budget = self.storm_budget - spent
            if budget <= 0:
                # escalate typed instead of forking unboundedly: the
                # degraded /healthz carries the WHY until the window
                # frees budget
                reason = (f"scale-storm budget exhausted: {spent} spawns "
                          f"in {self.storm_window_s:g}s (budget "
                          f"{self.storm_budget}); wanted {desired} "
                          f"workers ({why})")
                if not self._storm_reason:
                    self.events.emit("storm", "", reason, fleet=cur)
                self._storm_reason = reason
                return
            self._storm_reason = ""
            n = min(delta, budget)
            for _ in range(n):
                wid = self.supervisor.spawn_worker(detail=why)
                with self._lock:
                    self._spawn_times.append(now)
                if wid is None:
                    break  # spawn failed: degrade to the current fleet
            self._last_up = now
            with self._lock:
                self._actions.append((now, +1))
        else:
            if now - self._last_down < self.down_cooldown_s:
                return
            if self.supervisor.draining_count():
                # rolling drain: one worker leaves at a time, so live
                # sessions always migrate onto a STAYING worker
                return
            victim = self.supervisor.pick_victim()
            if victim is None:
                return
            self.supervisor.drain_worker(victim, detail=why)
            self._last_down = now
            with self._lock:
                self._actions.append((now, -1))

    def _publish(self, desired: int) -> None:
        sup = self.supervisor
        self._g_workers.set(desired, state="desired")
        self._g_workers.set(sup.ready_count(), state="ready")
        self._g_workers.set(
            sup.worker_count() - sup.ready_count(), state="joining")
        self._g_workers.set(sup.quarantined_count(), state="quarantined")
        if self.forecast_enabled:
            self._g_forecast.set(self._last_forecast)

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        sup = self.supervisor.stats()
        sig = self._last_signals
        with self._lock:
            out = {
                "name": self.name,
                "ticks": self.ticks,
                "min_workers": self.min_workers,
                "max_workers": self.max_workers,
                "workers": self.supervisor.worker_count(),
                "ready": self.supervisor.ready_count(),
                "fleet_size_min": self.fleet_size_min,
                "fleet_size_max": self.fleet_size_max,
                "damped": self._damped,
                "storm_reason": self._storm_reason,
                "last_decision": self._last_decision,
                "forecast_rps": self._last_forecast,
                "history_points": len(self._history),
            }
        out["signals"] = sig.snapshot() if sig is not None else {}
        out["supervisor"] = sup
        # the autoscaler's own ledger, hoisted for the CI gate:
        # spawns == joined + failed + quarantined + cancelled (+ pending)
        for k in ("spawns", "joined", "failed", "quarantined", "cancelled",
                  "pending", "ledger_exact"):
            out[k] = sup[k]
        out["events"] = self.events.snapshot()
        return out


__all__ = ["Autoscaler", "FleetSignals", "RouterSignals"]
