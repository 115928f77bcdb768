"""``input-selector`` / ``output-selector``: stream switching while the
pipeline plays.

The port of the JAX package's ``elements/selector.py``, the analog of the
GStreamer selectors the reference C API flips with
``ml_pipeline_switch_select`` (``nnstreamer.h:439-566``).  An
input-selector forwards the frames of one of its sink pads and drops the
others'; an output-selector sends each frame to one of its src pads.  Both
make their pads on request (the request-pad machinery of
``graph/node.py``): ``sel.src_0 ! ...`` links a new pad.  A switch takes
effect from the next frame; frames are handed on as they are.  Events other
than EOS and caps go to every src pad of an output-selector, and EOS
reaches every src pad of both.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..buffer import Event, Frame
from ..graph.node import Node, Pad
from ..graph.registry import register_element
from ..spec import TensorsSpec


@register_element("input-selector")
class InputSelector(Node):
    REQUEST_SINK_PADS = True

    def __init__(self, name: Optional[str] = None, active_pad: str = "sink_0"):
        super().__init__(name)
        self.add_src_pad("src")
        self.active = str(active_pad)

    def select(self, pad_name: str) -> None:
        if pad_name not in self.sink_pads:
            raise ValueError(f"{self.name}: no sink pad {pad_name!r}")
        self.active = pad_name

    def pads(self):
        return sorted(self.sink_pads)

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        specs = list(in_specs.values())
        merged = specs[0]
        for s in specs[1:]:
            m = merged.intersect(s)
            if m is None:
                # the inputs differ: the output spec follows the active pad
                merged = in_specs.get(self.active, specs[0])
                break
            merged = m
        return {"src": merged}

    def process(self, pad: Pad, frame: Frame):
        if pad.name != self.active:
            return None
        return frame


@register_element("output-selector")
class OutputSelector(Node):
    REQUEST_SRC_PADS = True

    def __init__(self, name: Optional[str] = None, active_pad: str = "src_0"):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.active = str(active_pad)

    def select(self, pad_name: str) -> None:
        if pad_name not in self.src_pads:
            raise ValueError(f"{self.name}: no src pad {pad_name!r}")
        self.active = pad_name

    def pads(self):
        return sorted(self.src_pads)

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        return {name: spec for name in self.src_pads}

    def process(self, pad: Pad, frame: Frame):
        del pad
        if self.active not in self.src_pads:
            return None
        return [(self.active, frame)]

    def on_event(self, pad: Pad, event: Event) -> None:
        del pad
        for spad in self.src_pads.values():
            spad.push(event)
