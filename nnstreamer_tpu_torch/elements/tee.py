"""``tee``: one stream to every linked src pad.

The port of the JAX package's ``elements/tee.py``: the same frame, and so
the same tensors, go to each branch in pad order; nothing is copied.  A
tensor is never written after it is made (a filter hands out fresh
outputs), so the branches can share it.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..buffer import Frame
from ..graph.node import Node, Pad
from ..graph.registry import register_element
from ..spec import TensorsSpec


@register_element("tee")
class Tee(Node):
    REQUEST_SRC_PADS = True

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.add_sink_pad("sink")

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        return {name: spec for name in self.src_pads}

    def process(self, pad: Pad, frame: Frame):
        del pad
        return [(name, frame) for name in self.src_pads]
