"""Fleet-scope chaos: drive the seeded ``fleet`` fault point against
live workers (the port of the JAX package's ``fleet/chaos.py``).

The :mod:`nnstreamer_tpu_torch.faults` engine owns the *decisions* (seeded
per-rule streams — same spec + same opportunity order = identical
schedule); this module owns the *application*, which needs process
handles the engine cannot hold:

- ``worker_kill`` → :meth:`handle.kill` (abrupt socket teardown;
  ``kill -9`` for subprocess fleets);
- ``worker_hang`` → :meth:`handle.hang` for ``rule.ms``;
- ``partition``   → cut the worker's health AND data channels for
  ``rule.ms`` (membership sees missed heartbeats, the router sees
  refused dials; live connections are NOT cut — a partition is not a
  crash).

A soak drives :meth:`FleetChaos.tick` on its own clock; every consult
is recorded in :attr:`consults` so a replay engine fed the identical
sequence reproduces the identical injection log (the property the fleet
soak test pins).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from .. import faults as _faults
from .membership import WorkerInfo
from .worker import FleetWorker


class InProcHandle:
    """Chaos handle for an in-process worker: the
    :class:`~.worker.FleetWorker` takes the kill/hang, the shared
    :class:`~.membership.WorkerInfo` takes the partition flags."""

    def __init__(self, worker: FleetWorker, info: WorkerInfo):
        self.worker = worker
        self.info = info

    def kill(self) -> None:
        self.worker.kill()

    def hang(self, ms: float) -> None:
        self.worker.hang(ms)

    def partition(self, ms: float) -> None:
        self.info.block_health = True
        self.info.block_data = True

        def heal():
            self.info.block_health = False
            self.info.block_data = False

        t = threading.Timer(ms / 1e3, heal)
        t.daemon = True
        t.start()


class FleetChaos:
    """Consult the ``fleet`` point once per (tick, worker) and apply."""

    def __init__(self, handles: Dict[str, object]):
        self.handles = handles
        self.consults: List[str] = []   # the replay witness
        self.applied: List[Tuple[str, str]] = []  # (worker, kind)

    def tick(self) -> None:
        # sorted: the consult order is part of the deterministic
        # opportunity stream a replay must reproduce
        for name in sorted(self.handles):
            self.consults.append(name)
            rule = _faults.maybe_fleet(name)
            if rule is None:
                continue
            self.apply(name, rule)

    def apply(self, name: str, rule) -> None:
        handle = self.handles[name]
        self.applied.append((name, rule.kind))
        if rule.kind == "worker_kill":
            handle.kill()
        elif rule.kind == "worker_hang":
            handle.hang(rule.ms)
        elif rule.kind == "partition":
            handle.partition(rule.ms)
