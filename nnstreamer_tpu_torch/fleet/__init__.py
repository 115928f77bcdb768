"""Fault-tolerant fleet serving: N worker processes behind one NNSQ door.

The port of the JAX package's ``fleet`` package: QueryServer and
DecodeServer scaled beyond one process, so that one worker crashing is no
outage.  Workers serve on the card (``device="cuda"``, the default) or, on
request, on the host:

- :mod:`.router` — the NNSQ-speaking front door: load-balances
  stateless query traffic with transparent re-route-and-retry across
  worker failures, pins stateful decode sessions sticky (typed
  ``[SESSION]`` fail-fast, never replayed), live-migrates them on a
  planned drain, meters cluster-wide admission via a front-door
  :class:`~nnstreamer_tpu_torch.sched.Scheduler`, and records
  ``nnsq_route`` spans so one request renders as client → router →
  worker → device in the Perfetto export;
- :mod:`.membership` — heartbeats against each worker's ``/healthz``
  JSON (healthy / degraded-deprioritized / warming / draining /
  unhealthy), suspect-vs-dead disambiguation (a heartbeat partition never
  tears sessions or duplicates dispatch), per-worker circuit breakers
  keyed by the incarnation nonce, ejection and probe-driven revival;
- :mod:`.worker` — one worker's servers + lifecycle: graceful SIGTERM
  drain, abrupt ``kill`` and ``restart`` for chaos/churn, the warming
  gate, and ``stats()`` with its process's kernel launch counts;
- :mod:`.repo` — ``tensor_repo`` over the wire, so cross-pipeline
  recurrence and session migration survive process boundaries
  (``[fleet] repo_addr``);
- :mod:`.chaos` — applies the faults engine's seeded fleet-scope kinds
  (``worker_kill`` / ``worker_hang`` / ``partition``) to live workers;
- :mod:`.supervisor` / :mod:`.autoscaler` — the self-healing elastic
  fleet: supervised spawn/respawn with crash-loop quarantine, and the
  SLO-driven control loop (hysteresis, per-direction cooldowns, flap
  damping, a scale-storm budget, a predictive diurnal leg).

``python -m nnstreamer_tpu_torch.fleet worker|router|repo|autoscale`` runs
each role as a process (see :mod:`.__main__`; ``--device cpu`` on the
host).  Not copied from the JAX package: the CPU-fallback degraded reason
(the port never serves a frame from the CPU after a capture fails) and
``--platform``.
"""

from .membership import (  # noqa: F401
    DEGRADED,
    DOWN,
    DRAINING,
    SUSPECT,
    UNHEALTHY,
    UP,
    WARMING,
    Membership,
    NoWorkerAvailable,
    WorkerInfo,
)
from .autoscaler import Autoscaler, FleetSignals, RouterSignals  # noqa: F401
from .chaos import FleetChaos, InProcHandle  # noqa: F401
from .repo import RemoteRepoError, RemoteTensorRepo, TensorRepoServer  # noqa: F401
from .router import Router  # noqa: F401
from .supervisor import (  # noqa: F401
    InProcWorkerFactory,
    ScaleEventLog,
    SpawnError,
    SubprocWorkerFactory,
    Supervisor,
    Surface,
)
from .worker import BUILTIN_MODELS, FleetWorker, ServeScope  # noqa: F401
