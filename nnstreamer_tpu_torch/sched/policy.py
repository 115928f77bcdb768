"""Pluggable scheduling policies: who dispatches next.

The port's copy of the JAX package's ``sched/policy.py`` (pure Python).
NNStreamer pushes QoS decisions into the dataflow layer — leaky queues,
``tensor_rate`` throttling, sync policies (arXiv:2101.06371 §3.3).  This
module is the request-level analog for the multi-tenant serving path:
given a set of queued schedulable items (a request, or a coalesced batch
group), a policy decides which one the single dispatch resource runs
next.

Items are :class:`SchedItem`: a client id, a cost (rows for a batched
invoke; 1 for a plain request), an optional priority and deadline, and an
opaque ``payload`` the caller dispatches.  Policies:

``fifo``   arrival order — the pre-scheduler behavior, as a policy.
``prio``   strict priority (higher first), FIFO within a level.
``edf``    earliest deadline first (no deadline sorts last), the classic
           soft-real-time order for deadline-carrying streams.
``drr``    deficit round robin (Shreedhar & Varghese): per-client FIFO
           queues served in a quantum-replenished round — a client whose
           items cost more (bigger batch groups) gets proportionally
           fewer dispatches per round, so one heavy/floody client cannot
           starve the others.  ``weights`` scale a client's quantum.

Policies are NOT thread-safe on their own; the owning
:class:`~nnstreamer_tpu_torch.sched.Scheduler` serializes every call under its
lock (same division of labor as the metrics registry vs its children).
"""

from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from typing import Callable, Dict, Optional

_seq = itertools.count()  # global FIFO tiebreaker across policies


class SchedItem:
    """One schedulable unit (request or coalesced group)."""

    __slots__ = ("client", "tenant", "cost", "priority", "deadline",
                 "enqueue_t", "payload", "seq")

    def __init__(self, client: str, cost: float = 1.0, priority: int = 0,
                 deadline: Optional[float] = None,
                 enqueue_t: float = 0.0, payload=None,
                 tenant: Optional[str] = None):
        self.client = str(client)
        # quota identity (host); fairness identity stays the client/stream
        self.tenant = str(tenant) if tenant is not None else self.client
        self.cost = float(cost)
        self.priority = int(priority)
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.enqueue_t = float(enqueue_t)
        self.payload = payload
        self.seq = next(_seq)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def __repr__(self):  # pragma: no cover — debugging aid
        return (f"SchedItem(client={self.client!r}, cost={self.cost}, "
                f"prio={self.priority}, deadline={self.deadline})")


class Policy:
    """Base: push items in, pop the next one to dispatch."""

    name = "?"

    def push(self, item: SchedItem) -> None:
        raise NotImplementedError

    def pop(self) -> Optional[SchedItem]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def deficits(self) -> Dict[str, float]:
        """Per-client deficit/credit snapshot (empty unless the policy
        tracks one — DRR does; published as gauges by the scheduler)."""
        return {}

    def stats(self) -> dict:
        return {"policy": self.name, "queued": len(self)}


class FifoPolicy(Policy):
    name = "fifo"

    def __init__(self):
        self._q: "deque[SchedItem]" = deque()

    def push(self, item: SchedItem) -> None:
        self._q.append(item)

    def pop(self) -> Optional[SchedItem]:
        return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        return len(self._q)


class PriorityPolicy(Policy):
    """Strict priority: higher ``item.priority`` first, FIFO within."""

    name = "prio"

    def __init__(self):
        self._heap: list = []

    def push(self, item: SchedItem) -> None:
        heapq.heappush(self._heap, (-item.priority, item.seq, item))

    def pop(self) -> Optional[SchedItem]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        return len(self._heap)


class EdfPolicy(Policy):
    """Earliest deadline first; items without a deadline sort last."""

    name = "edf"

    def __init__(self):
        self._heap: list = []

    def push(self, item: SchedItem) -> None:
        key = item.deadline if item.deadline is not None else math.inf
        heapq.heappush(self._heap, (key, item.seq, item))

    def pop(self) -> Optional[SchedItem]:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        return len(self._heap)


class DrrPolicy(Policy):
    """Deficit round robin across clients (weighted fairness).

    Each client gets a FIFO queue and a deficit counter.  A full pass of
    the active ring adds ``quantum * weight(client)`` to every visited
    client's deficit; a client at the head of the ring dispatches while
    its head item's cost fits its deficit.  Heavy items (big coalesced
    groups) therefore consume multiple rounds of credit — exactly the
    property that bounds how far one floody/expensive client can push
    everyone else's wait (O(1) per-packet work in the original paper;
    here per-pop amortized by ring rotation).
    """

    name = "drr"

    def __init__(self, quantum: float = 8.0,
                 weights: Optional[Dict[str, float]] = None):
        if quantum <= 0:
            raise ValueError("quantum must be > 0")
        self.quantum = float(quantum)
        self.weights = dict(weights or {})
        self._queues: Dict[str, deque] = {}
        self._deficit: Dict[str, float] = {}
        self._ring: "deque[str]" = deque()
        self._n = 0

    def _weight(self, client: str) -> float:
        w = float(self.weights.get(client, 1.0))
        return w if w > 0 else 1.0

    def push(self, item: SchedItem) -> None:
        q = self._queues.get(item.client)
        if q is None:
            q = self._queues[item.client] = deque()
            self._deficit.setdefault(item.client, 0.0)
            self._ring.append(item.client)
        q.append(item)
        self._n += 1

    def pop(self) -> Optional[SchedItem]:
        if not self._n:
            return None
        # terminates: every full rotation grows the head client's deficit
        # by quantum*weight, so its head item eventually fits
        while True:
            client = self._ring[0]
            q = self._queues[client]
            if self._deficit[client] >= q[0].cost:
                item = q.popleft()
                self._n -= 1
                self._deficit[client] -= item.cost
                if not q:
                    # an emptied client leaves the ring and forfeits its
                    # leftover credit (classic DRR: deficit only
                    # accumulates while backlogged)
                    self._ring.popleft()
                    del self._queues[client]
                    self._deficit[client] = 0.0
                return item
            self._deficit[client] += self.quantum * self._weight(client)
            self._ring.rotate(-1)

    def __len__(self) -> int:
        return self._n

    def deficits(self) -> Dict[str, float]:
        return dict(self._deficit)


_POLICIES: Dict[str, Callable[..., Policy]] = {}


def register_policy(name: str, factory: Callable[..., Policy]) -> None:
    """Register a policy factory (pluggable, like backends/elements)."""
    _POLICIES[name] = factory


register_policy("fifo", FifoPolicy)
register_policy("prio", PriorityPolicy)
register_policy("priority", PriorityPolicy)
register_policy("edf", EdfPolicy)
register_policy("drr", DrrPolicy)


def make_policy(name: str, **kwargs) -> Policy:
    """Instantiate a registered policy by name (kwargs go to the factory;
    factories ignore none — a wrong kwarg is a loud TypeError)."""
    try:
        factory = _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {name!r} "
            f"(known: {', '.join(sorted(_POLICIES))})") from None
    if factory in (FifoPolicy, PriorityPolicy, EdfPolicy):
        kwargs = {}  # these take no tuning knobs
    return factory(**kwargs)
