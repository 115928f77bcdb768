"""``valve``: a frame gate the application opens and closes while the
pipeline plays.

The port of the JAX package's ``elements/valve.py``, the analog of the
GStreamer valve that the reference C API drives
(``ml_pipeline_valve_set_open``, ``nnstreamer.h:439-566``): while closed
(``drop=true``) frames are dropped; events always pass.  A frame is handed
on as it is, on whatever device it lies.
"""

from __future__ import annotations

from typing import Optional

from ..buffer import Frame
from ..graph.node import Node, Pad
from ..graph.registry import register_element
from ..utils.props import parse_bool


@register_element("valve")
class Valve(Node):
    def __init__(self, name: Optional[str] = None, drop: bool = False):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.drop = parse_bool(drop, name="drop")

    def set_open(self, is_open: bool) -> None:
        self.drop = not is_open

    def process(self, pad: Pad, frame: Frame):
        del pad
        if self.drop:
            return None
        return frame
