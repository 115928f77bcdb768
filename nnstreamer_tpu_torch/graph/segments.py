"""Whole-segment compilation: one device call per run-to-completion region.

The port of the JAX package's ``graph/segments.py``.  Transform fusion
(:mod:`.optimize`) folds adjacent transforms into a filter; this pass
extends it to the filter's whole region: a trivial ``tensor_converter``
before the filter folds in as an identity pre-stage, and a decoder after
it whose plugin offers ``device_stage`` (``bounding_boxes`` decode + NMS,
``image_labeling`` argmax) folds in as the filter's last post-stage.  Each
frame then goes from its raw stream tensors to the decoder's small head
tensor in one ``invoke``, with no host synchronization in between, and the
decoder node, which stays in the graph, only reads that tensor and draws.

A region stops at a source, at a fan point (a node with several src pads
or several sink pads), and at any element with no device lowering:
non-trivial converters (frames-per-tensor batching), host transforms
(acceleration off) and decoders without ``device_stage`` are recorded in
the plan's ``fallbacks``, structural stops in its ``cuts``.

A decoder's lowering sets its ``lane_blocking`` hint for the dispatcher
lanes (``graph/lanes.py``): off when the heavy decode moved onto the card,
on when the decode stays on the host behind the fused boundary (the undo
puts back what was there).

Undo closures restore the unfused graph: on a failed start, on
``Pipeline.stop`` (the next start plans the user's graph afresh), and per
element at configure time when the decoder refuses its negotiated geometry
(``TensorFilter._install_fusion`` calls the stage's ``on_refuse``, which
puts the decoder back on the host).

Enable with ``[segment] enabled`` (``NNSTPU_SEGMENT_ENABLED=1``) or per
pipeline with ``pipeline.segment_compile = True``.  Each install and each
restore fires the ``segment`` hook (``obs/hooks.py``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Tuple

from ..obs import hooks as _hooks
from .node import Node
from .optimize import _hop_transparent, _is_fusable_filter, _splice_out
from .pipeline import Pipeline

__all__ = ["SegmentPlan", "plan_segments", "fuse_segments", "restore_segments",
           "segments_enabled"]


def segments_enabled(pipeline: Pipeline) -> bool:
    """A pipeline's ``segment_compile`` (True/False) overrides the
    ``[segment] enabled`` knob (default off)."""
    override = getattr(pipeline, "segment_compile", None)
    if override is not None:
        return bool(override)
    from ..conf import conf

    return conf.get_bool("segment", "enabled")


@dataclasses.dataclass
class SegmentPlan:
    """One filter's region: what folds, what cut the walk, and which
    elements could not lower."""

    filter: str
    pre: List[str]                      # converters folded as identity pre-stages
    post: List[str]                     # decoder folded as device head (at most 1)
    cuts: List[Tuple[str, str]]         # (node, reason) structural stops
    fallbacks: List[Tuple[str, str]]    # (node, reason) refused lowerings

    @property
    def label(self) -> str:
        """The folded region's element names in stream order."""
        return "+".join(self.pre + [self.filter] + self.post)

    @property
    def folds(self) -> bool:
        return bool(self.pre or self.post)


def _trivial_converter(node: Node) -> bool:
    """A converter whose negotiated transform is the identity: one tensor
    through, no re-batching, no byte reinterpretation.  (Timestamp
    synthesis and stride stripping do nothing for the port's sources.)"""
    from ..elements.converter import TensorConverter

    return (
        isinstance(node, TensorConverter)
        and node.frames_per_tensor == 1
        and not node.input_format
        and node.input_spec is None
        and len(node.sink_pads) == 1
        and len(node.src_pads) == 1
    )


def _boundary(node: Node) -> Tuple[str, bool]:
    """(reason, is_fallback): why ``node`` stops the walk.  A fallback is a
    recognized element in a configuration that does not lower; the rest
    are structural."""
    if not node.sink_pads:
        return "source", False
    if len(node.src_pads) > 1:
        return "fan-out", False
    if len(node.sink_pads) > 1:
        return "n-to-1 sync", False
    from ..elements.converter import TensorConverter
    from ..elements.tensor_if import TensorIf
    from ..elements.transform import TensorTransform

    if isinstance(node, TensorIf):
        return "control branch", False
    if isinstance(node, TensorConverter):
        return "non-trivial converter config", True
    if isinstance(node, TensorTransform):
        return "host transform (acceleration off)", True
    return "no device lowering", False


def plan_segments(pipeline: Pipeline) -> List[SegmentPlan]:
    """Walk the graph (read-only) and describe each torch filter's region.
    From ``Pipeline.start`` this runs after transform fusion, so the walk
    meets converters and decoders directly, hopping queue/upload plumbing
    as ``fuse_transforms`` does."""
    from ..elements.decoder import TensorDecoder

    plans: List[SegmentPlan] = []
    for filt in [n for n in pipeline.nodes.values() if _is_fusable_filter(n)]:
        pre: List[str] = []
        cuts: List[Tuple[str, str]] = []
        fallbacks: List[Tuple[str, str]] = []
        pad = _hop_transparent(filt.sink_pads["sink"].peer, "up")
        while pad is not None:
            node = pad.node
            if _trivial_converter(node):
                pre.insert(0, node.name)
                pad = _hop_transparent(next(iter(node.sink_pads.values())).peer, "up")
                continue
            reason, is_fb = _boundary(node)
            (fallbacks if is_fb else cuts).append((node.name, reason))
            break

        post: List[str] = []
        pad = _hop_transparent(filt.src_pads["src"].peer, "down")
        if pad is not None:
            node = pad.node
            if isinstance(node, TensorDecoder):
                if getattr(node.plugin, "device_stage", None) is not None:
                    # folded as a device head; the node stays as the host tail
                    # and may still refuse its geometry at configure
                    post.append(node.name)
                else:
                    fallbacks.append((node.name,
                                      f"decoder {node.mode!r} has no device lowering"))
            else:
                reason, is_fb = _boundary(node)
                (fallbacks if is_fb else cuts).append((node.name, reason))
        plans.append(SegmentPlan(filter=filt.name, pre=pre, post=post,
                                 cuts=cuts, fallbacks=fallbacks))
    return plans


class _IdentityStage:
    """A spliced trivial converter as a per-tensor fused pre-stage (the
    ``tensor_transform`` protocol): the identity."""

    def __init__(self, name: str):
        self.name = name

    def build_fn(self, spec):
        del spec
        return lambda x: x

    def describe(self, spec):
        del spec
        return ("identity", self.name)

    def out_spec_for(self, spec):
        return spec


class _DecoderStage:
    """A decoder folded as a device head: the N:M fused-stage protocol
    (``build_multi`` / ``on_refuse``).  Success flips the plugin to lowered
    mode, so the decoder node negotiates against the head's small tensor
    and runs only the host tail.

    Any exception from ``device_stage`` refuses the lowering and leaves the
    decode on the host, so a lowering does nothing there that may fail for
    another reason: the NMS kernel's library is built and loaded at its
    first launch, in the frame's ``invoke``, where a failure stops the
    pipeline.
    """

    def __init__(self, dec):
        self.dec = dec
        self.name = dec.name

    def build_multi(self, spec):
        plugin = self.dec.plugin
        try:
            built = plugin.device_stage(spec)
        except Exception as exc:  # noqa: BLE001 - a refusal degrades, never kills negotiation
            warnings.warn(f"{self.name}: device_stage failed, decoding on the host: {exc!r}",
                          RuntimeWarning, stacklevel=2)
            built = None
        if built is None:
            plugin.set_lowered(None)
            self.dec.lane_blocking = True  # the host decode stays: a heavy task
            return None
        fn, out_spec = built
        plugin.set_lowered(out_spec)
        self.dec.lane_blocking = False  # the heavy decode moved onto the card
        return fn, out_spec

    def on_refuse(self):
        self.dec.plugin.set_lowered(None)
        self.dec.lane_blocking = True

    def describe(self, spec):
        return ("tensor_decoder", self.dec.mode, self.dec.options, str(spec))


def fuse_segments(pipeline: Pipeline) -> List:
    """Carry out the plans: splice trivial converters out into identity
    pre-stages, attach decoder heads as post-stages, and label the backend.
    Returns the undo closures (run in reverse to restore the unfused graph)
    and stashes them on ``pipeline._segment_undos`` for ``Pipeline.stop``.
    Does nothing unless :func:`segments_enabled`."""
    undos: List = []
    if not segments_enabled(pipeline):
        return undos
    for plan in plan_segments(pipeline):
        if not plan.folds:
            continue
        filt = pipeline.nodes[plan.filter]
        for name in plan.pre:
            undos.append(_splice_out(pipeline, pipeline.nodes[name]))
        dec = pipeline.nodes[plan.post[0]] if plan.post else None

        old_pre, old_post = list(filt._fused_pre), list(filt._fused_post)
        new_pre = [_IdentityStage(n) for n in plan.pre] + old_pre
        new_post = old_post + ([_DecoderStage(dec)] if dec is not None else [])
        filt.set_fused_transforms(new_pre, new_post)
        be = filt.backend
        prev_label = be.segment_label
        be.segment_label = plan.label
        prev_hint = getattr(dec, "lane_blocking", None) if dec is not None else None
        if _hooks.enabled:
            _hooks.emit("segment", pipeline.name, filt.name, plan.label,
                        f"pre={len(plan.pre)} post={len(plan.post)} "
                        f"fallbacks={len(plan.fallbacks)}", "install")

        def undo_install(f=filt, d=dec, b=be, prev=prev_label, hint=prev_hint, op=old_pre,
                         opost=old_post, label=plan.label, pname=pipeline.name):
            f.set_fused_transforms(op, opost)
            if not op and not opost:
                b.set_wrapper(None)  # nothing fused: the bare model again
            b.segment_label = prev
            if d is not None:
                d.plugin.set_lowered(None)
                if hint is None:
                    d.__dict__.pop("lane_blocking", None)
                else:
                    d.lane_blocking = hint
            if _hooks.enabled:
                _hooks.emit("segment", pname, f.name, label, "", "restore")

        undos.append(undo_install)
    pipeline._segment_undos = list(undos)
    return undos


def restore_segments(pipeline: Pipeline) -> None:
    """Run (and clear) the pipeline's stashed segment undos."""
    undos = getattr(pipeline, "_segment_undos", None) or []
    pipeline._segment_undos = []
    for undo in reversed(undos):
        undo()
