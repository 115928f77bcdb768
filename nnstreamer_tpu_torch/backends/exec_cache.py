"""The fingerprint in the key of a captured geometry.

The port's counterpart of the JAX package's ``backends/exec_cache.py``.
The torch backend captures the filter's function once per negotiated
geometry as a ``torch.cuda.CUDAGraph`` (``backends/torch_backend.py``) and
keeps the captures in an in-memory LRU keyed by the input spec,
:func:`fingerprint` (the wrapper's stage descriptors, the model's
parameter shapes and dtypes, and a hash of the ``csrc/`` kernel sources)
and the dispatch mesh (``parallel/mesh.mesh_cache_key``: a geometry
captured over a mesh is another entry than the same geometry on one
device).
A capture whose function changed is therefore never selected again; it
ages out of the LRU.

Nothing is stored on disk.  A CUDA graph holds one process's device
addresses and cannot be reloaded, so an on-disk entry could only be the
meta-only witness the JAX package writes for what it cannot serialize,
and nothing here would read one.  The device name and the torch and CUDA
versions are left out of the key for the same reason: they cannot change
within a process.
"""

from __future__ import annotations

import hashlib
import json

import torch


def sources_digest() -> str:
    """sha256 over the CUDA sources the kernels are built from."""
    from ..ops.build import CSRC, SOURCES

    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    return h.hexdigest()


def param_signature(obj) -> list:
    """Shapes and dtypes of every tensor in a params tree (dicts, lists,
    tuples, objects with attributes, ``nn.Module`` state), in a stable
    order."""
    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    if isinstance(obj, torch.Tensor):
        return [str(obj.dtype), list(obj.shape)]
    if isinstance(obj, dict):
        return [[str(k), param_signature(v)] for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))]
    if isinstance(obj, (list, tuple)):
        return [param_signature(v) for v in obj]
    if hasattr(obj, "__dict__") and not callable(obj):
        return [type(obj).__name__, param_signature(vars(obj))]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return [repr(obj)]
    return [type(obj).__name__]


def fingerprint(stages, params) -> str:
    """sha256 over what a capture runs: the wrapper's stage descriptors,
    the parameter signature and the kernel sources."""
    blob = json.dumps([repr(stages), param_signature(params), sources_digest()])
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()
