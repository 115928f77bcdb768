"""Params checkpoints: the JAX package's ``utils/checkpoint.py`` file format.

A tree of dicts, lists and tuples whose leaves are arrays (or ``None``,
bools, ints, floats, strings) goes into one ``.npz``: each array as an
entry of its own, ``a0``, ``a1``, ..., and the nesting as one JSON
skeleton under ``__skeleton__``; no pickle.  A file the JAX package's
``save_state`` wrote loads here to the same tree, with numpy leaves, and a
file written here loads there.  A torch tensor leaf is saved as the numpy
array of its values (bfloat16 has no numpy dtype and is refused).

A directory is an orbax checkpoint, which the port does not restore: orbax
imports JAX, and the port never does.  Restore it with the JAX package's
``load_state`` and write it out with ``save_state`` as ``.npz``.  The JAX
package's pipeline and repo-slot checkpoint is not ported yet: it waits
for ``tensor_repo``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List

import numpy as np
import torch


def _pack(obj, arrays: List[np.ndarray]):
    if isinstance(obj, dict):
        return {"t": "d", "v": {k: _pack(v, arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"t": "l" if isinstance(obj, list) else "T",
                "v": [_pack(v, arrays) for v in obj]}
    if isinstance(obj, torch.Tensor):
        arrays.append(obj.detach().cpu().numpy())
        return {"t": "a", "v": len(arrays) - 1}
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        arrays.append(np.asarray(obj))
        return {"t": "a", "v": len(arrays) - 1}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "s", "v": obj}
    raise TypeError(f"cannot checkpoint leaf of type {type(obj).__name__}")


def _unpack(node, arrays) -> Any:
    t, v = node["t"], node["v"]
    if t == "d":
        return {k: _unpack(x, arrays) for k, x in v.items()}
    if t == "l":
        return [_unpack(x, arrays) for x in v]
    if t == "T":
        return tuple(_unpack(x, arrays) for x in v)
    if t == "a":
        return arrays[v]
    return v


def save_state(state: Dict[str, Any], path: str) -> None:
    arrays: List[np.ndarray] = []
    skeleton = _pack(state, arrays)
    np.savez(path, __skeleton__=np.frombuffer(json.dumps(skeleton).encode(), dtype=np.uint8),
             **{f"a{i}": a for i, a in enumerate(arrays)})


def load_state(path: str) -> Dict[str, Any]:
    """The tree in ``path`` (``.npz`` added when missing).  An orbax
    checkpoint directory ``path``, where no such ``.npz`` exists, raises
    ``ImportError`` and imports nothing: the JAX package's own error where
    orbax is absent, else one that names the ``.npz`` route."""
    p = str(path)
    npz = p if p.endswith(".npz") else f"{p}.npz"
    if not os.path.exists(npz) and os.path.isdir(p):
        if importlib.util.find_spec("orbax") is None:
            raise ImportError(
                f"{p!r} looks like an orbax checkpoint directory, but "
                "orbax-checkpoint is not installed — pip install "
                "nnstreamer-tpu[checkpoints]")
        raise ImportError(
            f"{p!r} looks like an orbax checkpoint directory, which the port does not "
            "restore (orbax imports JAX): restore it with the JAX package's load_state "
            "and write it out with its save_state as .npz")
    with np.load(npz) as z:
        skeleton = json.loads(bytes(z["__skeleton__"].tobytes()).decode())
        arrays = {int(k[1:]): z[k] for k in z.files if k != "__skeleton__"}
    return _unpack(skeleton, [arrays[i] for i in range(len(arrays))])
