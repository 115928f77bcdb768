"""Graph optimization: fold adjacent transforms into torch filters.

The port of the JAX package's ``graph/optimize.py``.  On start, a
``transform* → filter(torch) → transform*`` chain becomes one filter whose
backend runs ``post ∘ model ∘ pre`` in one call on the device
(:meth:`TensorFilter._install_fusion`): only the raw frame (uint8 for the
detection and labeling paths) crosses to the card, and the normalize runs
there.  A folded ``acceleration="pallas"`` transform still launches the
``fused_arith`` kernel once per frame.

Called from ``Pipeline.start`` (``pipeline.auto_fuse = False`` turns it
off).  Whole-segment compilation (:mod:`.segments`) reuses
:func:`_splice_out`.  Both walks hop over ``queue`` and
``tensor_upload`` (:func:`_hop_transparent`), so ``transform → upload →
queue → filter`` still folds and the upload carries the raw frame.
"""

from __future__ import annotations

from typing import List

from .node import Node
from .pipeline import Pipeline


def _is_fusable_transform(node: Node) -> bool:
    from ..elements.transform import TensorTransform

    return (
        isinstance(node, TensorTransform)
        and bool(node.acceleration)
        and len(node.sink_pads) == 1
        and len(node.src_pads) == 1
    )


def _is_fusable_filter(node: Node) -> bool:
    from ..backends.torch_backend import TorchBackend
    from ..elements.filter import TensorFilter

    return isinstance(node, TensorFilter) and isinstance(node.backend, TorchBackend)


def _hop_transparent(pad, direction: str):
    """Walk past spec-transparent 1-in/1-out plumbing (queue,
    tensor_upload), so transforms separated from the filter only by a
    thread or copy boundary still fold.  It stops at a fan point: hopping
    one would move a transform across other branches' streams."""
    from .residency import hop_plumbing

    return hop_plumbing(pad, direction)


def _splice_out(pipeline: Pipeline, node: Node):
    """Remove a 1-in/1-out node, reconnecting its neighbours.  Returns an
    undo closure restoring the original topology."""
    sink_pad = next(iter(node.sink_pads.values()))
    src_pad = next(iter(node.src_pads.values()))
    up = sink_pad.peer
    down = src_pad.peer
    up.peer = None
    sink_pad.peer = None
    src_pad.peer = None
    if down is not None:
        down.peer = None
        up.link(down)
    del pipeline.nodes[node.name]
    node.pipeline = None

    def undo():
        if down is not None:
            up.peer = None
            down.peer = src_pad
            src_pad.peer = down
        up.peer = sink_pad
        sink_pad.peer = up
        pipeline.nodes[node.name] = node
        node.pipeline = pipeline

    return undo


def fuse_transforms(pipeline: Pipeline) -> List:
    """Fold accelerated transforms around torch filters.  Returns undo
    closures; run in reverse they restore the unfused graph (``Pipeline.
    start`` does so when a later step of the start fails)."""
    undos: List = []
    for filt in [n for n in pipeline.nodes.values() if _is_fusable_filter(n)]:
        pre: List[Node] = []
        while True:
            peer = _hop_transparent(filt.sink_pads["sink"].peer, "up")
            if peer is None or not _is_fusable_transform(peer.node):
                break
            tr = peer.node
            undos.append(_splice_out(pipeline, tr))
            pre.insert(0, tr)
        post: List[Node] = []
        while True:
            peer = _hop_transparent(filt.src_pads["src"].peer, "down")
            if peer is None or not _is_fusable_transform(peer.node):
                break
            tr = peer.node
            undos.append(_splice_out(pipeline, tr))
            post.append(tr)
        if pre or post:
            filt.set_fused_transforms(pre, post)

            def undo_install(f=filt):
                f.set_fused_transforms([], [])
                f.backend.set_wrapper(None)

            undos.append(undo_install)
    return undos
