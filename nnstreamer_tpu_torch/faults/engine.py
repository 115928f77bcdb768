"""Deterministic, seeded fault injection: the chaos engine.

The port's copy of the JAX package's ``faults/engine.py``, with the same
grammar and the same seeded decisions: a run under a spec injects at the
same opportunities in both packages.  A streaming system earns its
robustness claims by surviving injected failure, not by never seeing one.
This engine turns the failure modes the runtime must tolerate (raising or
slow filter invokes, failing captures, wedged queues, dropped sockets,
torn and corrupted NNSQ frames, and the fleet faults of a tier the port
has yet to bring over) into
*reproducible* events: every decision comes from a per-rule
``random.Random`` stream seeded from ``(seed, kind, target)``, so two
engines built from the same spec replay the identical injection sequence
over the identical opportunity stream.

Spec grammar (``NNSTPU_FAULTS`` / ini ``[faults] spec``)::

    spec   := clause (';' clause)*
    clause := 'seed=' int
            | kind ['@' target] [':' param (',' param)*]
    param  := key '=' value

    kinds  : socket_drop | truncate | corrupt          (point nnsq_send)
             invoke_delay | invoke_raise | device_stall (point backend_invoke)
             compile_raise                              (point backend_compile)
             queue_wedge                                (point queue_wedge)
             worker_kill | worker_hang | partition      (point fleet)
             migrate_abort                              (point migrate)
             spawn_fail | scale_flap                    (point autoscale)
    params : rate=P    Bernoulli per opportunity (0 < P <= 1)
             every=N   deterministic: every Nth opportunity
             after=N   arm only after N opportunities (alone: fire ONCE)
             count=N   cap total injections for this rule
             ms=D      duration for delay/stall/wedge faults (milliseconds)

The port consults ``backend_invoke``, ``backend_compile``,
``queue_wedge`` and ``nnsq_send``; a rule of another point parses and never
fires until its subsystem is ported.  ``target`` is a substring matched
against the injection site's name (the node name, ``server``/``client``
for the NNSQ wire); empty matches everything.
Non-matching calls do not consume an opportunity, so the rule's random
stream, and therefore the replay, depends only on the traffic it applies
to.

Example::

    NNSTPU_FAULTS="seed=42;invoke_raise@f:every=5;compile_raise:count=1"

Every injection is appended to :attr:`ChaosEngine.log`, counted in
``nnstpu_faults_injected_total{point,kind}``, emitted on the ``fault``
hook, and recorded as a flight-recorder instant when span tracing is
active.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

# fault kind -> the injection point whose call sites consult it
POINT_OF = {
    "socket_drop": "nnsq_send",
    "truncate": "nnsq_send",
    "corrupt": "nnsq_send",
    "invoke_delay": "backend_invoke",
    "invoke_raise": "backend_invoke",
    "device_stall": "backend_invoke",
    "compile_raise": "backend_compile",
    "queue_wedge": "queue_wedge",
    # fleet scope: consulted per (tick, worker) by a fleet chaos
    # supervisor (not ported yet)
    "worker_kill": "fleet",
    "worker_hang": "fleet",
    "partition": "fleet",
    # live decode-session migration and elastic autoscaling (not ported
    # yet): a handoff phase, a spawn attempt, a controller tick
    "migrate_abort": "migrate",
    "spawn_fail": "autoscale",
    "scale_flap": "autoscale",
}

KINDS = frozenset(POINT_OF)
_PARAMS = frozenset({"rate", "every", "after", "count", "ms"})

DEFAULT_MS = 50.0  # delay/stall/wedge duration when the clause names none


class InjectedFault(RuntimeError):
    """Raised by a firing ``*_raise`` rule (a RuntimeError on purpose:
    the recovery machinery must treat chaos exactly like a real
    failure)."""

    def __init__(self, kind: str, target: str, opportunity: int):
        super().__init__(
            f"injected fault {kind!r} at {target!r} "
            f"(opportunity {opportunity})")
        self.kind = kind
        self.target = target
        self.opportunity = opportunity


class FaultRule:
    """One spec clause: matching, arming, and the seeded decision."""

    __slots__ = ("kind", "target", "rate", "every", "after", "count", "ms",
                 "opportunities", "injected", "_rng")

    def __init__(self, kind: str, target: str, params: Dict[str, float],
                 seed: int):
        self.kind = kind
        self.target = target
        self.rate = float(params.get("rate", 0.0))
        self.every = int(params.get("every", 0))
        self.after = int(params.get("after", 0))
        self.count = int(params.get("count", 0))
        self.ms = float(params.get("ms", DEFAULT_MS))
        if not (self.rate or self.every) and self.after and not self.count:
            self.count = 1  # bare after=N: a single-shot fault
        if not (self.rate or self.every or self.after or self.count):
            raise ValueError(
                f"fault clause {kind!r} needs rate=, every=, after=, "
                "or count=")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"{kind}: rate must be in [0, 1], got {self.rate}")
        self.opportunities = 0
        self.injected = 0
        # one stream per rule, derived stably from (seed, kind, target):
        # rules never perturb each other's sequences, and re-parsing the
        # same spec reproduces every stream (zlib.crc32: hash() is
        # process-salted for strings)
        self._rng = random.Random(
            (seed << 32) ^ zlib.crc32(f"{kind}@{target}".encode()))

    def matches(self, name: str) -> bool:
        return not self.target or self.target in name

    def decide(self) -> bool:
        """One (matching) opportunity; True = inject.  Caller holds the
        engine lock — the opportunity counter and rng stream are what
        make a run replayable."""
        self.opportunities += 1
        if self.count and self.injected >= self.count:
            return False
        if self.opportunities <= self.after:
            return False
        if self.every:
            fire = (self.opportunities - self.after) % self.every == 0
        elif self.rate:
            fire = self._rng.random() < self.rate
        else:
            fire = True  # bare after=N, count-capped above
        if fire:
            self.injected += 1
        return fire

    def stats(self) -> dict:
        return {
            "kind": self.kind,
            "target": self.target,
            "opportunities": self.opportunities,
            "injected": self.injected,
        }


def parse_spec(spec: str, seed: Optional[int] = None
               ) -> Tuple[int, List[FaultRule]]:
    """Parse the spec grammar; returns ``(seed, rules)``.  An explicit
    ``seed=`` clause wins over the ``seed`` argument (which defaults 0)."""
    rules: List[FaultRule] = []
    parsed_seed = None
    clauses = []
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if raw.startswith("seed="):
            parsed_seed = int(raw[5:])
            continue
        clauses.append(raw)
    if parsed_seed is not None:
        seed = parsed_seed
    seed = int(seed or 0)
    for raw in clauses:
        head, _, tail = raw.partition(":")
        kind, _, target = head.partition("@")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r} (known: {sorted(KINDS)})")
        params: Dict[str, float] = {}
        for part in tail.split(","):
            part = part.strip()
            if not part:
                continue
            k, eq, v = part.partition("=")
            k = k.strip()
            if not eq or k not in _PARAMS:
                raise ValueError(
                    f"fault clause {raw!r}: bad param {part!r} "
                    f"(known: {sorted(_PARAMS)})")
            params[k] = float(v)
        rules.append(FaultRule(kind, target.strip(), params, seed))
    return seed, rules


class ChaosEngine:
    """All rules of one spec + the injection log and counters."""

    def __init__(self, spec: str, seed: Optional[int] = None):
        self.spec = spec
        self.seed, rules = parse_spec(spec, seed)
        self._by_point: Dict[str, List[FaultRule]] = {}
        for rule in rules:
            self._by_point.setdefault(POINT_OF[rule.kind], []).append(rule)
        self.rules = rules
        self._lock = threading.Lock()
        # (point, kind, site name, rule opportunity index) per injection —
        # the replayability witness
        self.log: List[Tuple[str, str, str, int]] = []
        self.injections: Dict[str, int] = {}

    def points(self) -> frozenset:
        return frozenset(self._by_point)

    def decide(self, point: str, name: str = "",
               kinds=None) -> Optional[FaultRule]:
        """One opportunity at ``point``; returns the firing rule (first
        match wins) or None.  Fires are logged + counted here so every
        call site shares one accounting path.  ``kinds`` (optional
        iterable) restricts the consult to rules of those kinds — rules
        of other kinds at the same point do NOT consume an opportunity,
        so call sites that only understand one kind (e.g. the autoscale
        point's ``spawn_fail`` vs ``scale_flap``) keep every rule's
        random stream — and therefore the replay — well-defined."""
        rules = self._by_point.get(point)
        if not rules:
            return None
        with self._lock:
            for rule in rules:
                if kinds is not None and rule.kind not in kinds:
                    continue
                if not rule.matches(name):
                    continue
                if rule.decide():
                    self.log.append(
                        (point, rule.kind, name, rule.opportunities))
                    self.injections[rule.kind] = \
                        self.injections.get(rule.kind, 0) + 1
                    self._observe(point, rule, name)
                    return rule
        return None

    def _observe(self, point: str, rule: FaultRule, name: str) -> None:
        """Metrics + flight recorder + hook for one injection (failures
        here must never mask the fault itself)."""
        try:
            from ..obs import hooks as _hooks
            from ..obs import spans as _spans
            from ..obs.metrics import REGISTRY

            REGISTRY.counter(
                "nnstpu_faults_injected_total",
                "chaos-engine fault injections, by point and kind",
                labelnames=("point", "kind"),
            ).inc(1, point=point, kind=rule.kind)
            if _spans.enabled:
                _spans.record_instant(
                    f"fault:{rule.kind}", cat="fault", trace=(0, 0),
                    args={"point": point, "target": name,
                          "opportunity": rule.opportunities})
            if _hooks.enabled:
                _hooks.emit("fault", point, rule.kind, name)
        except Exception:  # noqa: BLE001 — observability stays non-fatal
            pass

    def sleep(self, rule: FaultRule) -> None:
        time.sleep(rule.ms / 1e3)

    def stats(self) -> dict:
        with self._lock:
            return {
                "spec": self.spec,
                "seed": self.seed,
                "injections": dict(self.injections),
                "rules": [r.stats() for r in self.rules],
            }
