"""The device mesh: one controller over a list of devices.

The port of the JAX package's ``parallel/mesh.py``.  The JAX mesh is
single-controller: one process drives every device of ``jax.devices()`` and
``shard_map`` runs one program a shard.  The port keeps that model, since
one ``Pipeline`` in one process owns the filter:

- :class:`Mesh` holds a numpy array of ``torch.device``s, the axis names
  and each position's id in the process's device list (:func:`visible_devices`);
- a sharded value is a list of per-device shards (:class:`Sharded`), and
  the collectives are plain functions over such lists: :func:`ppermute` is
  a rotation of the list, :func:`all_to_all` is split, move and cat,
  :func:`all_gather` gathers, :func:`all_reduce` reduces.  A shard moves
  with ``.to(device, non_blocking=True)``; nothing moves between two
  shards on one device.

``torch.distributed`` and ``DTensor`` are not used: they want one process a
rank, and NCCL refuses two ranks on one GPU, so a machine with one card
could only ever show a world of one.  A mesh here may repeat a device
(``[cuda:0] * 4``, ``[cpu] * 8``): :func:`force_device_count`, the
counterpart of ``--xla_force_host_platform_device_count``, makes the
process see ``n`` such devices, so that the CPU tests and ``chip_smoke.py``
run the real 4- and 8-shard algorithms on one device.  Only tests and
``chip_smoke.py`` call it; without it :func:`visible_devices` is the cards
``torch.cuda.device_count()`` counts, or the one CPU.

The dispatch mesh (``NNSTPU_MESH=dp:4``, ``[mesh] spec``) turns on
batch-sharded dispatch through the hot path, as in the JAX package:
the torch backend captures one graph a shard (``backends/sharded.py``), the
batch elements size their buckets in per-shard multiples and the query
server its groups.  A request for more devices than the process has clamps
down, ``auto`` takes them all; fewer than two devices is no mesh.

:func:`reduce_over_batch` is the collective a function makes when it runs
as one shard of a sharded dispatch: the value reduced over every shard of
the batch (the int8 head's activation scale, ``ops/quant.py``).  Outside
such a dispatch it returns its argument.

Not ported here (ROADMAP item 13b): ``init_distributed`` and
``init_from_env``, the multi-process side.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

_forced: Optional[List[torch.device]] = None


def force_device_count(n: Optional[int], device=None) -> None:
    """Make the process see ``n`` devices, each of them ``device`` (default:
    the first card when there is one, else the CPU); ``None`` restores the
    real list.  The counterpart of JAX's
    ``--xla_force_host_platform_device_count``, for tests and
    ``chip_smoke.py``.  Drops the cached dispatch mesh."""
    global _forced
    if n is None:
        _forced = None
    else:
        if device is None:
            device = "cuda:0" if torch.cuda.is_available() else "cpu"
        _forced = [torch.device(device)] * int(n)
    reset_dispatch_mesh()


def visible_devices() -> List[torch.device]:
    """The devices the process sees: the forced list, else every card,
    else the one CPU."""
    if _forced is not None:
        return list(_forced)
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _object_array(items, shape) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        arr[i] = x
    return arr.reshape(shape)


class Mesh:
    """Devices laid out on named axes.  ``devices``: an object array of
    ``torch.device``; ``ids``: each position's index in :func:`visible_devices`
    (the JAX device's ``id``), which labels it."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 ids: Optional[np.ndarray] = None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes {self.axis_names}")
        self.ids = (np.arange(self.devices.size).reshape(self.devices.shape)
                    if ids is None else np.asarray(ids).reshape(self.devices.shape))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _line(self, arr: np.ndarray, axis: str) -> list:
        """``arr`` along ``axis``, the other coordinates at 0."""
        k = self.axis_names.index(axis)
        index = tuple(slice(None) if i == k else 0 for i in range(arr.ndim))
        return list(arr[index])

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``: the shards of a value sharded on it."""
        return self._line(self.devices, axis)

    def axis_labels(self, axis: str) -> List[str]:
        """``<type>:<id>`` of each device along ``axis``."""
        return [f"{d.type}:{int(i)}" for d, i in zip(self._line(self.devices, axis),
                                                   self._line(self.ids, axis))]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Tuple[str, ...] = ("dp",),
              devices=None) -> Mesh:
    """A mesh over the first ``prod(shape)`` of ``devices`` (default:
    :func:`visible_devices`); the default shape is every device on the
    first axis."""
    devs = list(devices if devices is not None else visible_devices())
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, have {len(devs)}")
    return Mesh(_object_array(devs[:n], tuple(shape)), axis_names,
                np.arange(n).reshape(tuple(shape)))


def on_one_device(*meshes) -> bool:
    """Whether every device of the given meshes (None: none) is one device:
    a function sharded over them may be captured as one CUDA graph.  Across
    cards the in-model modes run eagerly, untried on more than one card."""
    devs = {str(d) for m in meshes if m is not None for d in m.devices.flat}
    return len(devs) <= 1


# -- placement ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a value's shards go: ``spec`` names, per dim, the mesh axis
    the dim is split over (None: whole); ``()`` replicates."""

    mesh: Mesh
    spec: tuple

    def _axis(self) -> Tuple[Optional[int], Optional[str]]:
        named = [(d, a) for d, a in enumerate(self.spec) if a is not None]
        if len(named) > 1:
            raise ValueError(f"sharding {self.spec}: one sharded dim at most")
        return named[0] if named else (None, None)

    @property
    def device_set(self) -> set:
        dim, axis = self._axis()
        if axis is None:
            return {f"{d.type}:{int(i)}" for d, i in zip(self.mesh.devices.flat,
                                                         self.mesh.ids.flat)}
        return set(self.mesh.axis_labels(axis))

    def place(self, x: torch.Tensor) -> "Sharded":
        """``x`` split (or copied) onto the mesh."""
        dim, axis = self._axis()
        if axis is None:
            return Sharded([move(x, d) for d in self.mesh.devices.flat], self)
        devs = self.mesh.axis_devices(axis)
        return Sharded(split(x, len(devs), dim, devs), self)


def batch_sharding(mesh: Mesh, rank: int, axis: str = "dp") -> NamedSharding:
    """The leading (batch) dim split over ``axis``, the rest whole."""
    return NamedSharding(mesh, (axis,) + (None,) * (rank - 1))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


class Sharded:
    """A value as its per-device shards and their placement."""

    def __init__(self, shards: List[torch.Tensor], sharding: NamedSharding):
        self.shards = list(shards)
        self.sharding = sharding

    @property
    def dim(self) -> Optional[int]:
        return self.sharding._axis()[0]

    def gather(self, device=None) -> torch.Tensor:
        """The whole value on ``device`` (default: the first shard's)."""
        device = self.shards[0].device if device is None else torch.device(device)
        if self.dim is None:
            return move(self.shards[0], device)
        return torch.cat([move(s, device) for s in self.shards], dim=self.dim)


# -- collectives over lists of shards -----------------------------------------


def move(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``; the same tensor when it is there already."""
    return t if t.device == torch.device(device) else t.to(device, non_blocking=True)


def split(x: torch.Tensor, n: int, dim: int, devs: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` cut into ``n`` equal shards along ``dim``, shard ``i`` on
    ``devs[i]`` (views where it is there already)."""
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split into {n} shards")
    return [move(c, d) for c, d in zip(x.chunk(n, dim=dim), devs)]


def ppermute(shards: List[torch.Tensor], devs: Sequence[torch.device],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``jax.lax.ppermute``: shard ``src`` goes to position ``dst`` for each
    pair; a position nothing is sent to gets zeros."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for src, dst in perm:
        out[dst] = move(shards[src], devs[dst])
    return [o if o is not None else torch.zeros_like(s, device=d)
            for o, s, d in zip(out, shards, devs)]


def rotate(shards: List[torch.Tensor], devs: Sequence[torch.device]) -> List[torch.Tensor]:
    """Each shard one step around the ring: position ``j`` to ``j + 1``."""
    n = len(shards)
    return ppermute(shards, devs, [(j, (j + 1) % n) for j in range(n)])


def all_to_all(shards: List[torch.Tensor], devs: Sequence[torch.device], split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """``jax.lax.all_to_all(tiled=True)``: each shard cut into ``n`` chunks
    along ``split_axis``; position ``j`` gets the ``j``-th chunk of every
    shard, in shard order, joined along ``concat_axis``."""
    n = len(shards)
    if shards[0].shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size {shards[0].shape[split_axis]} "
                         f"does not split into {n}")
    pieces = [s.chunk(n, dim=split_axis) for s in shards]
    return [torch.cat([move(pieces[i][j], devs[j]) for i in range(n)], dim=concat_axis)
            for j in range(n)]


def all_gather(shards: List[torch.Tensor], devs: Sequence[torch.device],
               axis: int = 0) -> List[torch.Tensor]:
    """Every position gets the shards joined along ``axis``."""
    return [torch.cat([move(s, d) for s in shards], dim=axis) for d in devs]


_REDUCE = {"max": lambda t: t.amax(0), "min": lambda t: t.amin(0), "sum": lambda t: t.sum(0)}


def all_reduce(shards: List[torch.Tensor], devs: Sequence[torch.device],
               op: str = "sum") -> List[torch.Tensor]:
    """Every position gets the shards reduced elementwise by ``op``
    (``max``, ``min`` or ``sum``)."""
    return [_REDUCE[op](torch.stack([move(s, d) for s in shards])) for d in devs]


# -- a collective inside a sharded dispatch ------------------------------------

_shard_ctx = threading.local()


def current_shard():
    """The sharded dispatch this thread runs one shard of (its phase
    runner, ``backends/sharded.py``), or None."""
    return getattr(_shard_ctx, "run", None)


def set_current_shard(run) -> None:
    _shard_ctx.run = run


def reduce_over_batch(t: torch.Tensor, op: str = "max") -> torch.Tensor:
    """``t``, one shard's value, reduced by ``op`` over every shard of the
    batch this call is a shard of: the collective XLA inserts for a
    reduction over a sharded batch axis.  Outside a sharded dispatch (a
    whole batch on one device) ``t`` is already the batch's value."""
    run = current_shard()
    return t if run is None else run.collective(t, op)


# -- the dispatch mesh (the process-wide data-parallel placement) --------------

_dispatch_mesh_cache: Optional[Tuple[tuple, Optional[Mesh], str]] = None


def parse_mesh_spec(spec: str) -> Tuple[str, int]:
    """``(axis, ndev)`` of a mesh spec: ndev 0 is every device, 1 is off."""
    s = (spec or "").strip().lower()
    if s in ("", "off", "none", "false", "0", "1"):
        return ("dp", 1)
    if s == "auto":
        return ("dp", 0)
    axis, sep, n = s.partition(":")
    if not sep:
        if axis.isdigit():
            return ("dp", int(axis))
        return (axis, 0)
    if not n.isdigit():
        raise ValueError(f"mesh spec {spec!r}: device count must be an integer, got {n!r}")
    return (axis or "dp", int(n))


def configured_mesh_spec() -> str:
    """The active spec: ``NNSTPU_MESH`` (the short spelling) over ``[mesh]
    spec`` (``NNSTPU_MESH_SPEC``) over off, read through the port's conf."""
    from ..conf import conf

    val = conf._environ.get("NNSTPU_MESH")
    if val is not None:
        return val
    return conf.get("mesh", "spec", "") or ""


def dispatch_mesh() -> Optional[Mesh]:
    """The process-wide dispatch mesh, or None when mesh mode is off or
    fewer than two devices are usable; built once a spec and device list."""
    global _dispatch_mesh_cache
    spec = configured_mesh_spec()
    devs = visible_devices()
    key = (spec, tuple(str(d) for d in devs))
    cached = _dispatch_mesh_cache
    if cached is not None and cached[0] == key:
        return cached[1]
    axis, ndev = parse_mesh_spec(spec)
    mesh = None
    if ndev != 1:
        if ndev == 0 or ndev > len(devs):
            ndev = len(devs)  # every device, or as many as there are
        if ndev > 1:
            mesh = make_mesh((ndev,), (axis,), devs)
    _dispatch_mesh_cache = (key, mesh, axis)
    return mesh


def dispatch_mesh_axis() -> str:
    """The dispatch mesh's batch axis ("dp" when off)."""
    mesh = dispatch_mesh()
    return "dp" if mesh is None else _dispatch_mesh_cache[2]


def dispatch_mesh_devices() -> int:
    """The dispatch mesh's device count (1 when off)."""
    mesh = dispatch_mesh()
    return mesh.size if mesh is not None else 1


def mesh_cache_key(mesh: Optional[Mesh]) -> Optional[tuple]:
    """A mesh's identity in a capture key: the axis layout and each
    position's device and id."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), tuple(mesh.shape[a] for a in mesh.axis_names),
            tuple((str(d), int(i)) for d, i in zip(mesh.devices.flat, mesh.ids.flat)))


def reset_dispatch_mesh() -> None:
    """Forget the cached dispatch mesh: the next use reads conf again."""
    global _dispatch_mesh_cache
    _dispatch_mesh_cache = None


def tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a dict / list / tuple tree; other leaves
    pass."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree
