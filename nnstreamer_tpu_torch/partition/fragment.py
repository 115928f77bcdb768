"""Serve a pipeline *fragment* behind NNSQ: the server half of a split.

The port of the JAX package's ``partition/fragment.py``.  A
:class:`FilterBackend` ("fragment") whose *model* is a launch-string chain:
:func:`~nnstreamer_tpu_torch.graph.parse.split_launch` hands the server
fragment to a :class:`~nnstreamer_tpu_torch.elements.query.QueryServer`
(``framework="fragment"``), and every NNSQ request drives the chain
synchronously, so a fragment inherits the whole server surface: the
per-spec backend LRU, caps negotiation (:data:`~nnstreamer_tpu_torch.
elements.query.FLAG_CAPS` probes land in :meth:`reconfigure`), drain and
chaos on the wire.

Fragments are strictly linear: one sink pad, one src pad, exactly one
output frame per input frame.  ``queue`` elements are dropped at open: a
thread boundary means nothing inside a synchronous invoke (the wire is the
boundary).  As ``Pipeline.start`` does (``graph/optimize.py``), accelerated
transforms next to a torch filter fold into it
(:meth:`~nnstreamer_tpu_torch.elements.filter.TensorFilter.set_fused_transforms`),
so on the card the normalize and the model replay as one CUDA graph, the
graph the in-process pipeline replays.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..backends.base import FilterBackend, register_backend
from ..buffer import Frame
from ..graph import registry as _registry
from ..graph.parse import ParseError, linear_chain
from ..spec import TensorsSpec

# elements that only move frames between threads: no-ops inside a
# synchronous backend invoke
_ELIDED = {"queue"}


def _fold(nodes: List) -> List:
    """Fold the accelerated transforms right before and after each torch
    filter into it; returns the remaining stages."""
    from ..graph.optimize import _is_fusable_filter, _is_fusable_transform

    out = list(nodes)
    for filt in [n for n in out if _is_fusable_filter(n)]:
        i = out.index(filt)
        lo = i
        while lo > 0 and _is_fusable_transform(out[lo - 1]):
            lo -= 1
        hi = i + 1
        while hi < len(out) and _is_fusable_transform(out[hi]):
            hi += 1
        if lo < i or hi > i + 1:
            filt.set_fused_transforms(out[lo:i], out[i + 1:hi])
            out[lo:hi] = [filt]
    return out


@register_backend("fragment")
class FragmentBackend(FilterBackend):
    """Host a linear element chain as a query-servable model."""

    def open(self, model, custom: str = "") -> None:
        del custom
        if not isinstance(model, str) or not model.strip():
            raise ValueError(
                "fragment backend needs a launch-string chain as its "
                f"model (got {model!r})")
        self._desc = model
        self._nodes: List = []
        self._in_spec: Optional[TensorsSpec] = None
        self._out_spec: Optional[TensorsSpec] = None
        nodes = []
        for etype, props in linear_chain(model):
            if etype in _ELIDED:
                continue
            kwargs = {k.replace("-", "_"): v for k, v in props.items()}
            name = kwargs.pop("name", None)
            node = _registry.make(etype, element_name=name, **kwargs)
            if len(node.sink_pads) != 1 or len(node.src_pads) != 1:
                raise ParseError(
                    f"fragment element {etype!r} is not 1-in/1-out "
                    f"({len(node.sink_pads)} sink, {len(node.src_pads)} "
                    "src pads): only linear stages can be offloaded")
            nodes.append(node)
        if not nodes:
            raise ValueError(f"fragment {model!r} has no servable stages")
        for node in _fold(nodes):
            node.start()
            self._nodes.append(node)

    def close(self) -> None:
        for node in getattr(self, "_nodes", []):
            try:
                node.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self._nodes = []

    def input_spec(self) -> Optional[TensorsSpec]:
        return self._in_spec

    def model_spec(self) -> Optional[TensorsSpec]:
        # the negotiation template is the first stage's sink template,
        # never the last negotiated shape
        if not self._nodes:
            return None
        node = self._nodes[0]
        return node.sink_spec(next(iter(node.sink_pads)))

    def output_spec(self) -> Optional[TensorsSpec]:
        return self._out_spec

    def reconfigure(self, in_spec: TensorsSpec) -> TensorsSpec:
        """Walk the caller's spec through the chain as the in-process
        negotiator would: template intersect, then the commit phase, stage
        by stage."""
        spec = in_spec
        for node in self._nodes:
            sink_name = next(iter(node.sink_pads))
            template = node.sink_spec(sink_name)
            merged = template.intersect(spec)
            if merged is None:
                raise ValueError(
                    f"fragment stage {node.name}: spec {spec} rejected "
                    f"by template {template}")
            node.sink_pads[sink_name].spec = merged
            out_specs = node.configure({sink_name: merged})
            spec = out_specs[next(iter(node.src_pads))]
        self._in_spec = in_spec
        self._out_spec = spec
        return spec

    def invoke(self, tensors: Tuple) -> Tuple:
        frame = Frame.of(*tensors)
        for node in self._nodes:
            sink_pad = node.sink_pads[next(iter(node.sink_pads))]
            result = node.process(sink_pad, frame)
            frame = self._one_frame(node, result)
        return frame.tensors

    @staticmethod
    def _one_frame(node, result) -> Frame:
        if isinstance(result, Frame):
            return result
        if result is None:
            raise RuntimeError(
                f"fragment stage {node.name} produced no frame: "
                "buffering/aggregating elements cannot be offloaded "
                "(1 frame in must be 1 frame out)")
        frames = [item[1] if isinstance(item, tuple) else item
                  for item in result]
        if len(frames) != 1:
            raise RuntimeError(
                f"fragment stage {node.name} produced {len(frames)} "
                "frames for one input: only 1-in/1-out stages can be "
                "offloaded")
        return frames[0]
