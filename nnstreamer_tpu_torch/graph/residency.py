"""Device-residency walk over the graph, shared by the hot-path elements.

The port's copy of the JAX package's ``graph/residency.py``.  A frame's
tensors stay on the card between torch filters when every element in
between passes payloads through untouched.  ``tensor_upload`` asks the
filter downstream for the device to copy to, and the fusion passes hop
over the same plumbing (``graph/optimize.py::_hop_transparent``).

The passthrough types (:func:`passthrough_types`) are ``queue`` and
``tensor_upload``: the fusion walks here, as in the JAX package, hop no
fan point (tee, mux, demux), which would move a transform across other
branches' streams.  The residency walk (:func:`chain_device_resident`)
also crosses tee, mux, demux and the batch elements, which pass tensors
on where they are.  The batch elements ask :func:`consumer_platform`
where their consumer computes, and :func:`consumer_mesh_devices` how many
shards its dispatch mesh cuts a batch into.
"""

from __future__ import annotations

from .node import Node


def passthrough_types() -> tuple:
    """The 1-in/1-out element types a frame crosses untouched."""
    from ..elements.queue import Queue
    from ..elements.upload import TensorUpload

    return (Queue, TensorUpload)


def hop_plumbing(pad, direction: str, transparent=None, max_hops: int = 4):
    """Follow 1-in/1-out nodes of the ``transparent`` types (default:
    :func:`passthrough_types`) from ``pad`` (a peer pad) up- or downstream;
    the first pad whose node is not transparent, or None where the chain
    ends or branches."""
    if transparent is None:
        transparent = passthrough_types()
    up = direction == "up"
    hops = 0
    while pad is not None and isinstance(pad.node, transparent) and hops < max_hops:
        pads = pad.node.sink_pads if up else pad.node.src_pads
        if len(pads) != 1:
            break
        pad = next(iter(pads.values())).peer
        hops += 1
    return pad


def downstream_filter_node(node: Node, max_hops: int = 4):
    """The first backend-carrying node downstream of ``node``, hopping over
    passthrough plumbing; None when the chain ends, branches, or lands on
    a node without a backend."""
    pads = node.src_pads
    if len(pads) != 1:
        return None
    pad = hop_plumbing(next(iter(pads.values())).peer, "down", max_hops=max_hops)
    if pad is None or getattr(pad.node, "backend", None) is None:
        return None
    return pad.node


def downstream_backend(node: Node, max_hops: int = 4):
    """The backend of :func:`downstream_filter_node`, or None."""
    filt = downstream_filter_node(node, max_hops)
    return getattr(filt, "backend", None) if filt is not None else None


def _resident_types() -> tuple:
    """The element types that pass a frame's tensors on where they are."""
    from ..elements.batch import TensorBatch, TensorUnbatch
    from ..elements.demux import TensorDemux
    from ..elements.mux import TensorMux
    from ..elements.tee import Tee

    return passthrough_types() + (Tee, TensorBatch, TensorUnbatch, TensorDemux, TensorMux)


def _device_type(backend):
    device = getattr(backend, "device", None)
    return getattr(device, "type", None)


def consumer_platform(node: Node, max_hops: int = 4):
    """The device type (``"cuda"`` or ``"cpu"``) of the filter backend
    downstream of ``node``, or None when there is none (or it has no
    device)."""
    return _device_type(downstream_backend(node, max_hops))


def consumer_mesh_devices(node: Node, max_hops: int = 4) -> int:
    """The device count of the dispatch mesh the filter downstream of
    ``node`` shards a batch over (1: unsharded; ``parallel/mesh.py``), so
    that the batch elements and the query server size their buckets in
    per-shard multiples."""
    get = getattr(downstream_backend(node, max_hops), "mesh_devices", None)
    if not callable(get):
        return 1
    try:
        return max(1, int(get()))
    except Exception:  # noqa: BLE001 - a sick backend must not fail negotiation
        return 1


def dispatch_mesh():
    """The process-wide dispatch mesh (None: off), re-exported from
    ``parallel/mesh.py`` for the graph layer."""
    from ..parallel.mesh import dispatch_mesh as _dispatch_mesh

    return _dispatch_mesh()


def chain_device_resident(node: Node, direction: str, max_hops: int = 4) -> bool:
    """Whether the frames on ``node``'s up- or downstream side are on the
    card: a filter on CUDA within ``max_hops`` elements that pass tensors
    on where they are (:func:`_resident_types`).  Any other element (a
    converter, a host transform, a decoder, a sink) stops the walk."""
    pads = node.sink_pads if direction == "up" else node.src_pads
    if len(pads) != 1:
        return False
    pad = hop_plumbing(next(iter(pads.values())).peer, direction, _resident_types(), max_hops)
    if pad is None:
        return False
    return _device_type(getattr(pad.node, "backend", None)) == "cuda"
