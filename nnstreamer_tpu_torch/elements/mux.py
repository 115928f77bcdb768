"""``tensor_mux``: N streams → one frame holding every stream's tensors.

The port of the JAX package's ``elements/mux.py``: each synchronized
collection round (:class:`~.collect.CollectNode`) emits one frame whose
tensors are every sink pad's tensors, in pad order.  The tensors are handed
on as they are: a device tensor stays where it is, and nothing is copied.
With the span tracer on, the round's frame gets a span of its own, linked
to the span of every frame it collected (``obs/spans.merge_context``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..buffer import Frame
from ..graph.node import NegotiationError
from ..graph.registry import register_element
from ..obs import spans as _spans
from ..spec import NNS_TENSOR_SIZE_LIMIT, TensorsSpec
from .collect import CollectNode


def _pad_order(names):
    return sorted(names, key=lambda n: (len(n), n))


@register_element("tensor_mux")
class TensorMux(CollectNode):
    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        tensors = []
        rate = None
        for name in _pad_order(in_specs):
            spec = in_specs[name]
            tensors.extend(spec.tensors)
            if spec.rate is not None:
                rate = spec.rate if rate is None else min(rate, spec.rate)
        if len(tensors) > NNS_TENSOR_SIZE_LIMIT:
            raise NegotiationError(
                f"{self.name}: muxed frame would exceed {NNS_TENSOR_SIZE_LIMIT} tensors")
        return {"src": TensorsSpec(tensors=tuple(tensors), rate=rate)}

    def combine(self, frames: Dict[str, Frame]) -> Optional[Frame]:
        tensors = []
        for name in _pad_order(frames):
            tensors.extend(frames[name].tensors)
        pts, dur = self.output_timing(frames)
        meta: Dict[str, Any] = {}
        if _spans.enabled:
            _spans.merge_context(frames.values(), meta, self.name)
        return Frame(tensors=tuple(tensors), pts=pts, duration=dur, meta=meta)
