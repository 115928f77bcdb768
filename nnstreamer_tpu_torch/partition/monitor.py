"""Repartitioning: re-score when the measured world moves.

The port's copy of the JAX package's ``partition/monitor.py``.

Two triggers, both observed (never polled from the planner):

- **wire regime flip** — the deployed edge's published regime
  (``obs/util.py`` per-addr records, re-probed by the watchdog's wire
  cadence) differs from the regime the plan was priced at;
- **stage-cost drift** — a stage's pooled per-frame cost in the cost
  model has moved away from the cost the plan priced by more than the
  perfdiff noise band (``leg_std_us × [partition] noise_multiplier``).

On a trigger the monitor re-plans from fresh inputs.  Only a *changed
cut* re-deploys (make-before-break through the warming gate and the
migrate-first drain — ``deploy.redeploy``); either way the recorded
baseline advances to the new plan, so one flip causes exactly one
re-deploy, not one per tick."""

from __future__ import annotations

import threading
from typing import Optional

from ..obs import costmodel as _costmodel
from ..obs import util as _util
from .deploy import PartitionDeployment
from .planner import _placement_scale, plan_partition, stage_cost_us


class RepartitionMonitor:
    """Watch one deployment; re-plan on regime flips and cost drift."""

    def __init__(self, deployment: PartitionDeployment, *,
                 interval_s: Optional[float] = None,
                 noise_multiplier: Optional[float] = None,
                 peaks: Optional[dict] = None,
                 registry=None):
        from ..conf import conf

        self.deployment = deployment
        self.interval_s = (
            float(interval_s) if interval_s is not None
            else conf.get_float("partition", "monitor_interval_s", 1.0))
        self.noise_multiplier = (
            float(noise_multiplier) if noise_multiplier is not None
            else conf.get_float("partition", "noise_multiplier", 3.0))
        self._peaks = peaks
        self._registry = registry
        self.evaluations = 0
        self.triggers = 0
        self.last_trigger: Optional[str] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the baseline the next evaluation compares against: the plan
        # currently deployed (its regime + the stage costs it priced)
        self._baseline = deployment.plan

    # -- trigger detection ---------------------------------------------------

    def _current_regime(self) -> Optional[str]:
        addr = self.deployment.addr or self._baseline.addr
        record = _util.wire_health_by_addr().get(addr)
        if record is None:
            return None
        return record.get("regime")

    def _drifted_stage(self, cost_model: dict) -> Optional[str]:
        """First stage whose fresh pooled cost left the noise band
        around the cost the deployed plan priced, or None."""
        plan = self._baseline
        stages = cost_model.get("stages") or {}
        for name, placement, priced_us in plan.chosen.stages:
            key = _costmodel.stage_key(plan.pipeline, name, plan.bucket,
                                       plan.mesh)
            entry = stages.get(key)
            fresh_us = stage_cost_us(entry)
            band = 0.0
            for leg in ("dispatch", "device_exec", "queue_wait"):
                std = _costmodel.leg_std_us(
                    (entry or {}).get("legs", {}).get(leg) or {})
                if std is not None:
                    band += std
            if placement == "server":
                # the plan priced server stages placement-scaled; scale
                # the fresh measurement (and its noise band) the same
                # way or every roofline-scaled stage "drifts" instantly
                scale = _placement_scale(entry, self._peaks)
                fresh_us *= scale
                band *= scale
            band *= self.noise_multiplier
            if band <= 0.0:
                continue  # under-sampled legs: no defensible verdict
            if abs(fresh_us - priced_us) > band:
                return (f"{name}: {priced_us:.1f}us -> {fresh_us:.1f}us "
                        f"(band {band:.1f}us)")
        return None

    # -- the loop body -------------------------------------------------------

    def evaluate_once(self) -> Optional[str]:
        """One monitor tick: detect, re-plan, re-deploy if the cut
        changed.  Returns the trigger reason, or None (no action)."""
        self.evaluations += 1
        plan = self._baseline
        reason = None
        regime = self._current_regime()
        if regime is not None and regime != plan.regime:
            reason = f"wire regime flip: {plan.regime} -> {regime}"
        cost_model = _costmodel.load_cost_model()
        if reason is None:
            drift = self._drifted_stage(cost_model)
            if drift is not None:
                reason = f"stage cost drift: {drift}"
        if reason is None:
            return None
        self.triggers += 1
        self.last_trigger = reason
        new_plan = plan_partition(
            plan.description,
            pipeline=plan.pipeline,
            addr=self.deployment.addr or plan.addr,
            edge=plan.edge,
            cost_model=cost_model,
            bucket=plan.bucket,
            mesh=plan.mesh,
            peaks=self._peaks,
        )
        if new_plan.cut != plan.cut:
            self.deployment.redeploy(new_plan, registry=self._registry)
        else:
            # same placement under the new inputs: no churn, but the
            # baseline advances so this trigger fires exactly once
            self.deployment.plan = new_plan
        self._baseline = new_plan
        return reason

    # -- optional background loop --------------------------------------------

    def start(self) -> "RepartitionMonitor":
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"repartition:{self._baseline.edge}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:  # noqa: BLE001 — the monitor must survive
                import logging

                logging.getLogger("nnstreamer_tpu_torch.partition").exception(
                    "repartition evaluation failed")

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
