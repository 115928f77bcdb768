"""Device-residency walk over the graph, shared by the hot-path elements.

The port's copy of the JAX package's ``graph/residency.py``.  A frame's
tensors stay on the card between torch filters when every element in
between passes payloads through untouched.  ``tensor_upload`` asks the
filter downstream for the device to copy to, and the fusion passes hop
over the same plumbing (``graph/optimize.py::_hop_transparent``).

The passthrough types (:func:`passthrough_types`) are ``queue`` and
``tensor_upload``: the two walks here, as in the JAX package, hop no fan
point (tee, mux, demux), which would move a transform across other
branches' streams.  The JAX package's wider residency walk
(``chain_device_resident``, which also crosses tee, mux, demux and the
batch elements) comes with the batch elements.
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
