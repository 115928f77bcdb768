"""Score every candidate pipeline cut from measured costs.

The among-device question — "which stages should run remotely?" — is
answered here from two measured inputs, never heuristics:

- **COST_MODEL.json** (``obs/costmodel.py``): per (pipeline, node,
  bucket, mesh) stage entries whose pooled legs give the per-frame host
  dispatch, true device execution, and queue-wait cost, plus the
  flops/bytes cost profile when the executable registered one;
- **wire health per edge** (``obs/util.py``): the candidate edge's
  measured 150 KB put time and dispatch overhead.

The port's copy of the JAX package's ``partition/planner.py``: the same
pricing, so the same inputs give a byte-identical plan and fingerprint in
both packages.  The placement peaks are the port's own, keyed on the
card's name (:func:`card_peaks`, from ``obs/util.py``'s table), never a
TPU's.

A candidate cut ``k`` keeps interior stages ``< k`` on the client,
moves stages ``>= k`` to the server, and pays one round trip per frame
priced at the edge's put rate; ``cut=None`` is the all-local placement
(no wire, no server).  The score is::

    total_us(k) = Σ client stage cost
                + Σ server stage cost × placement scale
                + transfer_us(k)

where the placement scale is the roofline-time ratio of the two
placements when per-placement peaks and a stage cost profile are known,
else 1.0 (a stage costs what it measured, wherever it runs).  The
argmin wins; ties break toward the earliest candidate in scan order
(all-local first, then ascending ``k``) — fewer moved stages on equal
measured evidence.

Everything is pure data → data: same cost model + same wire record →
byte-identical :class:`PartitionPlan` (fingerprint-pinned by test), so
a plan can be re-derived offline from the banked inputs.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..graph.parse import ParseError, linear_chain
from ..obs import costmodel as _costmodel
from ..obs import util as _util

# legs that are compute residency on a placement (the wire leg is
# re-priced per edge, not carried over)
_COMPUTE_LEGS = ("dispatch", "device_exec", "queue_wait")
_PROBE_NBYTES = 150_528  # the wire probe's reference payload


def _conf_float(key: str, default: float) -> float:
    from ..conf import conf

    try:
        return conf.get_float("partition", key, default)
    except ValueError:
        return default


def stage_cost_us(entry: Optional[dict]) -> float:
    """Per-frame compute-side cost of one stage entry: the sum of its
    pooled dispatch/device_exec/queue_wait leg means (µs).  Absent
    entries or legs cost 0 — unknown is neutral, never a penalty."""
    if not entry:
        return 0.0
    total = 0.0
    for leg in _COMPUTE_LEGS:
        stat = (entry.get("legs") or {}).get(leg)
        if stat:
            total += float(stat.get("mean_us") or 0.0)
    return total


def card_peaks(client: Optional[str] = None,
               server: Optional[str] = None) -> dict:
    """``{"client": {"tflops", "gbs"}, "server": {...}}`` roofline peaks of
    two placements, each the published peak of the card of that name
    (:func:`~nnstreamer_tpu_torch.obs.util.peak_tflops` /
    :func:`~nnstreamer_tpu_torch.obs.util.peak_gbs`; default: card 0's
    name, or the host row without a card)."""
    return {side: {"tflops": _util.peak_tflops(name), "gbs": _util.peak_gbs(name)}
            for side, name in (("client", client), ("server", server))}


def _roofline_s(flops: Optional[float], nbytes: Optional[float],
                peak: Optional[dict]) -> Optional[float]:
    """Roofline execution time (s) of one frame on a placement with
    ``{"tflops": ..., "gbs": ...}`` peaks; None when underdetermined."""
    if not peak:
        return None
    times = []
    if flops and peak.get("tflops"):
        times.append(float(flops) / (float(peak["tflops"]) * 1e12))
    if nbytes and peak.get("gbs"):
        times.append(float(nbytes) / (float(peak["gbs"]) * 1e9))
    return max(times) if times else None


def _placement_scale(entry: Optional[dict], peaks: Optional[dict]) -> float:
    """Server-vs-client cost ratio for one stage: the roofline-time
    ratio when the stage has a cost profile and both placements have
    peaks, else 1.0 (measured cost carries over unscaled)."""
    if not entry or not peaks:
        return 1.0
    flops = entry.get("flops_per_frame")
    nbytes = entry.get("bytes_per_frame")
    t_client = _roofline_s(flops, nbytes, peaks.get("client"))
    t_server = _roofline_s(flops, nbytes, peaks.get("server"))
    if not t_client or not t_server:
        return 1.0
    return t_server / t_client


@dataclass(frozen=True)
class CutScore:
    """One candidate's cost attribution (µs per frame)."""

    cut: Optional[int]          # None = all-local; k = first remote stage
    total_us: float
    client_us: float
    server_us: float
    transfer_us: float
    # (stage name, "client" | "server", priced µs) per interior stage
    stages: Tuple[Tuple[str, str, float], ...] = ()

    def to_dict(self) -> dict:
        return {
            "cut": self.cut,
            "total_us": self.total_us,
            "client_us": self.client_us,
            "server_us": self.server_us,
            "transfer_us": self.transfer_us,
            "stages": [list(s) for s in self.stages],
        }


@dataclass(frozen=True)
class PartitionPlan:
    """A typed, reproducible placement decision.

    ``cut`` indexes the launch chain's elements: stages ``[cut, n-1)``
    run remotely (``None`` = keep everything local).  ``scores`` holds
    every candidate's attribution in scan order; ``chosen`` is the
    winner.  ``fingerprint`` hashes the exact pricing inputs, so two
    plans agree iff their inputs did."""

    pipeline: str
    description: str
    addr: str
    edge: str
    cut: Optional[int]
    chosen: CutScore
    scores: Tuple[CutScore, ...]
    regime: str
    put_150k_ms: Optional[float]
    bucket: int = 0
    mesh: int = 1
    fingerprint: str = field(default="")

    @property
    def split(self) -> bool:
        return self.cut is not None

    def score_for(self, cut: Optional[int]) -> Optional[CutScore]:
        for s in self.scores:
            if s.cut == cut:
                return s
        return None

    def to_dict(self) -> dict:
        return {
            "pipeline": self.pipeline,
            "description": self.description,
            "addr": self.addr,
            "edge": self.edge,
            "cut": self.cut,
            "regime": self.regime,
            "put_150k_ms": self.put_150k_ms,
            "bucket": self.bucket,
            "mesh": self.mesh,
            "fingerprint": self.fingerprint,
            "chosen": self.chosen.to_dict(),
            "scores": [s.to_dict() for s in self.scores],
        }


def _stage_entry(stages: Dict[str, dict], pipeline: str, name: str,
                 bucket: int, mesh: int) -> Optional[dict]:
    return stages.get(_costmodel.stage_key(pipeline, name, bucket, mesh))


def _cut_bytes_for(elements, cut: int, stages: Dict[str, dict],
                   pipeline: str, bucket: int, mesh: int,
                   names: List[str],
                   default_bytes: float) -> float:
    """Bytes crossing the wire per frame at ``cut``: the first remote
    stage's measured staged-copy bytes when the cost model has them,
    else the configured default."""
    entry = _stage_entry(stages, pipeline, names[cut], bucket, mesh)
    if entry and entry.get("copy_bytes_per_frame"):
        return float(entry["copy_bytes_per_frame"])
    return default_bytes


def plan_partition(
    description: str,
    *,
    pipeline: str,
    addr: str,
    edge: str = "",
    cost_model: Optional[dict] = None,
    wire_health: Optional[dict] = None,
    bucket: int = 0,
    mesh: int = 1,
    peaks: Optional[dict] = None,
    default_cut_bytes: Optional[float] = None,
) -> PartitionPlan:
    """Score every cut of ``description`` and return the plan.

    ``cost_model`` defaults to the persisted ``COST_MODEL.json``;
    ``wire_health`` defaults to the last published probe for ``addr``
    (:func:`~nnstreamer_tpu_torch.obs.util.wire_health_by_addr`).  With no
    put-rate measurement for the edge, remote candidates price transfer
    at +inf — an unprobed wire is never chosen, it is measured first
    (``deploy.probe_edge_health``).  ``peaks`` optionally carries
    ``{"client": {"tflops", "gbs"}, "server": {...}}`` roofline peaks
    for placement-scaled stage costs."""
    elements = linear_chain(description)
    n = len(elements)
    if n < 3:
        raise ParseError(
            f"cannot partition a {n}-element chain (need source, "
            "stages, sink)"
        )
    if not edge:
        from ..conf import conf

        edge = conf.get("partition", "edge", "edge0") or "edge0"
    if cost_model is None:
        cost_model = _costmodel.load_cost_model()
    stages = cost_model.get("stages") or {}
    if wire_health is None:
        wire_health = _util.wire_health_by_addr().get(addr)
    put_ms = (wire_health or {}).get("put_150k_ms")
    dispatch_ms = (wire_health or {}).get("dispatch_ms")
    if default_cut_bytes is None:
        default_cut_bytes = _conf_float("default_cut_bytes",
                                        float(_PROBE_NBYTES))

    # stable stage names: explicit name= wins, else the parse_launch
    # auto-name a collision-free chain would get ({etype}{ordinal})
    names: List[str] = []
    per_type_idx: Dict[str, int] = {}
    for etype, props in elements:
        name = props.get("name")
        if not name:
            idx = per_type_idx.get(etype, 0)
            per_type_idx[etype] = idx + 1
            name = f"{etype}{idx}"
        names.append(name)

    interior = list(range(1, n - 1))
    costs = {
        i: stage_cost_us(_stage_entry(stages, pipeline, names[i],
                                      bucket, mesh))
        for i in interior
    }
    scales = {
        i: _placement_scale(_stage_entry(stages, pipeline, names[i],
                                         bucket, mesh), peaks)
        for i in interior
    }

    def transfer_us(cut: int) -> float:
        if put_ms is None:
            return math.inf
        nbytes = _cut_bytes_for(elements, cut, stages, pipeline, bucket,
                                mesh, names, float(default_cut_bytes))
        # request and reply priced symmetrically at the probed put
        # rate, plus the edge's fixed per-round-trip dispatch overhead
        us = 2.0 * float(put_ms) * 1e3 * (nbytes / _PROBE_NBYTES)
        if dispatch_ms is not None:
            us += float(dispatch_ms) * 1e3
        return us

    scores: List[CutScore] = []
    for cut in [None] + interior:
        client_us = server_us = 0.0
        attribution = []
        for i in interior:
            if cut is None or i < cut:
                us = costs[i]
                client_us += us
                attribution.append((names[i], "client", round(us, 3)))
            else:
                us = costs[i] * scales[i]
                server_us += us
                attribution.append((names[i], "server", round(us, 3)))
        xfer = 0.0 if cut is None else transfer_us(cut)
        scores.append(CutScore(
            cut=cut,
            total_us=round(client_us + server_us + xfer, 3),
            client_us=round(client_us, 3),
            server_us=round(server_us, 3),
            transfer_us=round(xfer, 3),
            stages=tuple(attribution),
        ))

    chosen = scores[0]
    for s in scores[1:]:
        if s.total_us < chosen.total_us:
            chosen = s

    fp_inputs = {
        "description": description,
        "pipeline": pipeline,
        "addr": addr,
        "edge": edge,
        "bucket": bucket,
        "mesh": mesh,
        "costs": {names[i]: round(costs[i], 3) for i in interior},
        "scales": {names[i]: round(scales[i], 6) for i in interior},
        "put_150k_ms": put_ms,
        "dispatch_ms": dispatch_ms,
        "default_cut_bytes": float(default_cut_bytes),
    }
    fingerprint = hashlib.sha256(
        json.dumps(fp_inputs, sort_keys=True).encode()).hexdigest()[:12]

    return PartitionPlan(
        pipeline=pipeline,
        description=description,
        addr=addr,
        edge=edge,
        cut=chosen.cut,
        chosen=chosen,
        scores=tuple(scores),
        regime=_util.wire_regime(put_ms),
        put_150k_ms=put_ms,
        bucket=bucket,
        mesh=mesh,
        fingerprint=fingerprint,
    )
