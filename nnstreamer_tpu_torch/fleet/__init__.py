"""The fleet tier, in part: the remote ``tensor_repo``.

The port of the JAX package's ``fleet/repo.py``
(:class:`~nnstreamer_tpu_torch.fleet.repo.TensorRepoServer`,
:class:`~nnstreamer_tpu_torch.fleet.repo.RemoteTensorRepo`).  The router,
membership, worker, supervisor and autoscaler wait for the rest of ROADMAP
item 14.
"""

from .repo import RemoteRepoError, RemoteTensorRepo, TensorRepoServer  # noqa: F401
