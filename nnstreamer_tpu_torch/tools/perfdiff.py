"""perfdiff: typed regression verdicts over persisted performance evidence.

The port's counterpart of the JAX package's ``tools/perfdiff.py``.  It
compares two snapshots of the port's ``COST_MODEL.json`` (per-stage leg
aggregates from the port's cost-observatory tracer, ``obs/costmodel.py``,
the JAX package's schema) and, where both are given, two MFU ladder banks
(a ``{"mfu_ladder": {...}}`` document or a bare bank; no default path: the
ladder is compared only from files named on the command line), and emits
one typed verdict per comparable series:

- ``flat``       — the delta sits inside the noise band;
- ``improved``   — current is better by more than the band
  (lower µs for stage legs, higher MFU for ladder cells);
- ``regressed``  — current is worse by more than the band; the verdict
  carries WHICH leg regressed (``dispatch`` / ``device_exec`` /
  ``queue_wait`` / ``wire`` / ``mfu``), because "the pipeline got
  slower" is not actionable and "the wire leg got slower" is.

The noise band is derived from the evidence itself: stage legs persist
Welford aggregates (count/mean/m2), so the band is
``max(sigmas × sample-std, min_rel × baseline, min_abs)`` — a leg that
historically swings 40% does not page anyone over a 10% delta.  Ladder
cells bank single best-of measurements (no variance), so they use the
relative band alone.

A self-compare (baseline == current) is ``flat`` by construction.  The report is NON-FATAL by default (exit 0, it is
an observability artifact, not a gate); ``--strict`` exits 1 when any
verdict regressed.  Every regression also increments
``nnstpu_perf_regression_total{leg}`` so a scrape of a long-lived
process that runs perfdiff periodically shows regression pressure over
time.

Usage::

    python -m nnstreamer_tpu_torch.tools.perfdiff        # self-compare (flat)
    python -m nnstreamer_tpu_torch.tools.perfdiff --baseline old.json --current new.json
    python -m nnstreamer_tpu_torch.tools.perfdiff --bank-baseline a.json --bank-current b.json
    python -m nnstreamer_tpu_torch.tools.perfdiff --json --strict
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from ..obs import costmodel
from ..obs.metrics import REGISTRY

DEFAULT_SIGMAS = costmodel.BAND_SIGMAS
DEFAULT_MIN_REL = costmodel.BAND_MIN_REL
DEFAULT_MIN_ABS_US = costmodel.BAND_MIN_ABS_US


def _regression_counter(registry=None):
    registry = registry if registry is not None else REGISTRY
    return registry.counter(
        "nnstpu_perf_regression_total",
        "Regressed perfdiff verdicts, by leg "
        "(dispatch/device_exec/queue_wait/wire/mfu)", ("leg",))


def stage_band_us(leg_stat: dict, sigmas: float = DEFAULT_SIGMAS,
                  min_rel: float = DEFAULT_MIN_REL,
                  min_abs_us: float = DEFAULT_MIN_ABS_US) -> float:
    """Noise band (µs) for one persisted stage-leg aggregate — the one
    implementation lives in :func:`costmodel.leg_band_us` (forensics
    scores outliers with the same band)."""
    return costmodel.leg_band_us(leg_stat, sigmas=sigmas, min_rel=min_rel,
                                 min_abs_us=min_abs_us)


def diff_cost_models(baseline: dict, current: dict,
                     sigmas: float = DEFAULT_SIGMAS,
                     min_rel: float = DEFAULT_MIN_REL,
                     min_abs_us: float = DEFAULT_MIN_ABS_US) -> List[dict]:
    """One verdict per (stage, leg) present in BOTH documents."""
    verdicts: List[dict] = []
    b_stages = baseline.get("stages") or {}
    c_stages = current.get("stages") or {}
    for key in sorted(set(b_stages) & set(c_stages)):
        b_legs = b_stages[key].get("legs") or {}
        c_legs = c_stages[key].get("legs") or {}
        for leg in sorted(set(b_legs) & set(c_legs)):
            b = float(b_legs[leg].get("mean_us") or 0.0)
            c = float(c_legs[leg].get("mean_us") or 0.0)
            band = stage_band_us(b_legs[leg], sigmas=sigmas,
                                 min_rel=min_rel, min_abs_us=min_abs_us)
            delta = c - b
            if abs(delta) <= band:
                verdict = "flat"
            elif delta < 0:
                verdict = "improved"
            else:
                verdict = "regressed"
            verdicts.append({
                "kind": "stage", "key": key, "leg": leg,
                "baseline_us": round(b, 3), "current_us": round(c, 3),
                "delta_us": round(delta, 3), "band_us": round(band, 3),
                "verdict": verdict,
            })
    return verdicts


def diff_ladder_banks(baseline: dict, current: dict,
                      min_rel: float = DEFAULT_MIN_REL) -> List[dict]:
    """One verdict per ladder cell key present in BOTH banks (compared
    on MFU; higher is better)."""
    verdicts: List[dict] = []
    for key in sorted(set(baseline) & set(current)):
        b = (baseline[key] or {}).get("mfu")
        c = (current[key] or {}).get("mfu")
        if b is None or c is None:
            continue
        band = min_rel * abs(float(b))
        delta = float(c) - float(b)
        if abs(delta) <= band:
            verdict = "flat"
        elif delta > 0:
            verdict = "improved"
        else:
            verdict = "regressed"
        verdicts.append({
            "kind": "ladder", "key": key, "leg": "mfu",
            "baseline_mfu": round(float(b), 5),
            "current_mfu": round(float(c), 5),
            "delta_mfu": round(delta, 5), "band_mfu": round(band, 5),
            "verdict": verdict,
        })
    return verdicts


def overall_verdict(verdicts: List[dict]) -> str:
    kinds = {v["verdict"] for v in verdicts}
    if "regressed" in kinds:
        return "regressed"
    if "improved" in kinds:
        return "improved"
    return "flat"


def report(verdicts: List[dict], registry=None) -> dict:
    """Counts + overall verdict; bumps the regression counter per
    regressed leg."""
    counter = _regression_counter(registry)
    regressed_legs: Dict[str, int] = {}
    for v in verdicts:
        if v["verdict"] == "regressed":
            counter.inc(leg=v["leg"])
            regressed_legs[v["leg"]] = regressed_legs.get(v["leg"], 0) + 1
    return {
        "verdict": overall_verdict(verdicts),
        "compared": len(verdicts),
        "flat": sum(1 for v in verdicts if v["verdict"] == "flat"),
        "improved": sum(1 for v in verdicts if v["verdict"] == "improved"),
        "regressed": sum(1 for v in verdicts if v["verdict"] == "regressed"),
        "regressed_legs": regressed_legs,
        "verdicts": verdicts,
    }


def _load_bank(path: Optional[str]) -> Optional[dict]:
    if not path:
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except Exception:  # noqa: BLE001 — absent evidence, empty comparison
        return {}
    if isinstance(doc, dict) and isinstance(doc.get("mfu_ladder"), dict):
        return doc["mfu_ladder"]
    return doc if isinstance(doc, dict) else {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="typed perf-regression verdicts over the port's COST_MODEL.json "
                    "and two MFU ladder banks")
    ap.add_argument("--baseline", default=None,
                    help="baseline COST_MODEL.json (default: the "
                         "configured live path — self-compare)")
    ap.add_argument("--current", default=None,
                    help="current COST_MODEL.json (default: the "
                         "configured live path)")
    ap.add_argument("--bank-baseline", default=None,
                    help="baseline ladder bank (a document with an mfu_ladder "
                         "key, or a bare bank); ladder cells are only "
                         "compared when both bank paths are given")
    ap.add_argument("--bank-current", default=None,
                    help="current ladder bank")
    ap.add_argument("--sigmas", type=float, default=DEFAULT_SIGMAS)
    ap.add_argument("--min-rel", type=float, default=DEFAULT_MIN_REL)
    ap.add_argument("--min-abs-us", type=float, default=DEFAULT_MIN_ABS_US)
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when any verdict regressed (default: "
                         "always exit 0 — the report is non-fatal)")
    args = ap.parse_args(argv)

    live = costmodel.cost_model_path()
    base_doc = costmodel.load_cost_model(args.baseline or live)
    cur_doc = costmodel.load_cost_model(args.current or live)
    verdicts = diff_cost_models(base_doc, cur_doc, sigmas=args.sigmas,
                                min_rel=args.min_rel,
                                min_abs_us=args.min_abs_us)
    b_bank = _load_bank(args.bank_baseline)
    c_bank = _load_bank(args.bank_current)
    if b_bank is not None and c_bank is not None:
        verdicts += diff_ladder_banks(b_bank, c_bank, min_rel=args.min_rel)

    rep = report(verdicts)
    if args.json:
        print(json.dumps(rep, indent=1, sort_keys=True))
    else:
        for v in verdicts:
            if v["kind"] == "stage":
                print(f"{v['verdict']:>9}  {v['key']} [{v['leg']}]  "
                      f"{v['baseline_us']} -> {v['current_us']} us  "
                      f"(band {v['band_us']})")
            else:
                print(f"{v['verdict']:>9}  {v['key']} [mfu]  "
                      f"{v['baseline_mfu']} -> {v['current_mfu']}  "
                      f"(band {v['band_mfu']})")
        print(f"# perfdiff: {rep['verdict']} — {rep['compared']} compared, "
              f"{rep['flat']} flat / {rep['improved']} improved / "
              f"{rep['regressed']} regressed"
              + (f" {rep['regressed_legs']}" if rep["regressed_legs"]
                 else ""))
    if args.strict and rep["regressed"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
