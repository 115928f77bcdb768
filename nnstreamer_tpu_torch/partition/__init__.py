"""Among-device pipeline partitioning: the server half of a split.

The port of the JAX package's ``partition`` package, in part: the
:mod:`~nnstreamer_tpu_torch.partition.fragment` backend, which serves the
server fragment of :func:`~nnstreamer_tpu_torch.graph.parse.split_launch`
behind a ``QueryServer``.  The planner, deployment and repartition monitor
wait for the rest of ROADMAP item 14.
"""

from .fragment import FragmentBackend  # noqa: F401
