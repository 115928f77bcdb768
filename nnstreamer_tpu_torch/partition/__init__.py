"""Among-device pipeline partitioning (ROADMAP item 3).

Split one linear pipeline across machines at a measured-cost-optimal
cut: :mod:`~nnstreamer_tpu_torch.partition.planner` scores every candidate
boundary from the cost observatory's per-stage legs (COST_MODEL.json)
plus per-edge wire-health probes, :mod:`~nnstreamer_tpu_torch.partition.
deploy` materializes the winning :class:`~nnstreamer_tpu_torch.partition.
planner.PartitionPlan` (client fragment local, server fragment on a
warming-gated :class:`~nnstreamer_tpu_torch.fleet.worker.FleetWorker` running
the :mod:`~nnstreamer_tpu_torch.partition.fragment` backend), and
:mod:`~nnstreamer_tpu_torch.partition.monitor` re-scores on wire-regime flips
or stage-cost drift and re-deploys through the migrate-first drain
path.

The port's copy of the JAX package's ``partition`` package: the same plan
and fingerprint for the same inputs; the server fragment's worker runs on
the card unless asked for the CPU, in this process or in a worker process
of its own (:class:`~nnstreamer_tpu_torch.partition.deploy.SubprocFragmentWorker`).
"""

from .deploy import (  # noqa: F401
    PartitionDeployment,
    SubprocFragmentWorker,
    probe_edge_health,
    subproc_worker_factory,
)
from .fragment import FragmentBackend  # noqa: F401
from .monitor import RepartitionMonitor  # noqa: F401
from .planner import (  # noqa: F401
    CutScore,
    PartitionPlan,
    card_peaks,
    plan_partition,
    stage_cost_us,
)
