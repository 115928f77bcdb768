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
``load_state`` and write it out with ``save_state`` as ``.npz``.

A pipeline's checkpoint (:func:`checkpoint_pipeline`) is its resumable
state in the same format: each node's ``state_dict()`` and the repo slots,
the recurrence state of an LSTM or RNN cycle (:func:`snapshot_repo`).  A
snapshot reads a slot's device tensors to numpy; a restore puts them back
on the device of the pipeline that restores them.  A checkpoint written by
either package restores in the other.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..buffer import Frame


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


# -- repo slots --------------------------------------------------------------

def snapshot_repo(repo=None) -> Dict[str, Any]:
    """Every slot of ``repo`` (the global one by default): its EOS flag and
    its pending frame, the tensors read to numpy."""
    from ..elements.repo import GLOBAL_REPO

    repo = repo if repo is not None else GLOBAL_REPO
    with repo._lock:
        items = list(repo._slots.items())
    slots = {}
    for idx, slot in items:
        with slot.cond:
            f = slot.frame
            slots[str(idx)] = {"eos": slot.eos,
                               "frame": None if f is None else _frame_state(f)}
    return slots


def _frame_state(f: Frame) -> Dict[str, Any]:
    """One slot's frame as a checkpoint holds it: tensors read to numpy."""
    return {"tensors": [t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                        else np.asarray(t) for t in f.tensors],
            "pts": f.pts, "duration": f.duration, "meta": dict(f.meta)}


def restore_repo(slots: Dict[str, Any], repo=None, device="cpu") -> None:
    """Put a snapshot back into ``repo``, each frame's tensors on
    ``device``; each slot is marked restored, so the next start keeps its
    frame and the repo source skips its zero bootstrap."""
    from ..elements.repo import GLOBAL_REPO

    repo = repo if repo is not None else GLOBAL_REPO
    dev = torch.device(device)
    for idx_s, entry in slots.items():
        slot = repo.slot(int(idx_s))
        fr = entry["frame"]
        with slot.cond:
            slot.eos = bool(entry["eos"])
            slot.frame = None if fr is None else Frame(
                tensors=tuple(torch.from_numpy(np.array(a)).to(dev) for a in fr["tensors"]),
                pts=int(fr["pts"]), duration=int(fr["duration"]),
                meta=dict(fr.get("meta", {})))
            slot.restored = True
            slot.cond.notify_all()


# -- pipelines ---------------------------------------------------------------

def _pipeline_repo(pipeline):
    """The repo the pipeline's repo elements use; the global one where they
    use several (checkpoint those with :func:`snapshot_repo`)."""
    from ..elements.repo import GLOBAL_REPO

    repos = {id(n.repo): n.repo for n in pipeline.nodes.values() if hasattr(n, "repo")}
    return next(iter(repos.values())) if len(repos) == 1 else GLOBAL_REPO


def _pipeline_device(pipeline) -> torch.device:
    """Where the pipeline's repo sources keep the state: their device."""
    for n in pipeline.nodes.values():
        if hasattr(n, "repo") and isinstance(getattr(n, "device", None), torch.device):
            return n.device
    return torch.device("cpu")


def _cycle_states(pipeline, repo) -> Dict[str, Frame]:
    """The last frame each repo sink of a cycle published (a slot that a
    repo source of the same pipeline reads), by slot.  Once a cycle's
    stream ended, that frame is its state, but its slot may be empty: the
    source may have taken the frame and handed it to a collect element that
    had already ended the stream, which dropped it."""
    from ..elements.repo import TensorRepoSink, TensorRepoSrc

    read = {n.slot_index for n in pipeline.nodes.values()
            if isinstance(n, TensorRepoSrc) and n.repo is repo}
    return {str(n.slot_index): n.last_published for n in pipeline.nodes.values()
            if isinstance(n, TensorRepoSink) and n.repo is repo and n.slot_index in read
            and n.last_published is not None}


def checkpoint_pipeline(pipeline, path: str, include_repo: bool = True,
                        repo=None) -> Dict[str, Any]:
    """Write the resumable state of ``pipeline`` to ``path`` (.npz).  Call it
    while the pipeline is stopped: node state is not synchronized with
    running dataflow.  A slot of a cycle that holds no frame gets the frame
    its repo sink published last (:func:`_cycle_states`), so that a cycle
    stopped at the end of its stream resumes where it stopped; the file's
    format is the JAX package's."""
    nodes = {}
    for name, node in pipeline.nodes.items():
        fn = getattr(node, "state_dict", None)
        if fn is not None:
            nodes[name] = fn()
    state: Dict[str, Any] = {"nodes": nodes}
    if include_repo:
        repo = repo if repo is not None else _pipeline_repo(pipeline)
        slots = snapshot_repo(repo)
        for idx, f in _cycle_states(pipeline, repo).items():
            entry = slots.setdefault(idx, {"eos": False, "frame": None})
            if entry["frame"] is None:
                entry["frame"] = _frame_state(f)
        state["repo"] = slots
    save_state(state, path)
    return state


def restore_pipeline(pipeline, path: str, repo=None) -> None:
    """Restore what :func:`checkpoint_pipeline` wrote into a pipeline whose
    nodes have the same names (as a pipeline from the same launch string)."""
    state = load_state(path)
    for name, node_state in state.get("nodes", {}).items():
        node = pipeline.nodes.get(name)
        fn = getattr(node, "load_state", None) if node is not None else None
        if fn is not None:
            fn(node_state)
    if "repo" in state:
        restore_repo(state["repo"], repo if repo is not None else _pipeline_repo(pipeline),
                     device=_pipeline_device(pipeline))
