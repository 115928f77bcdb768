"""``tensor_sink``: the application-facing stream terminal.

Calls the application's ``callback`` with every frame; ``collect`` keeps the
frames in :attr:`TensorSink.frames`.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..buffer import Frame
from ..graph.node import Pad, SinkTerminal
from ..graph.registry import register_element


@register_element("tensor_sink")
class TensorSink(SinkTerminal):
    def __init__(
        self,
        name: Optional[str] = None,
        collect: bool = False,
        callback: Optional[Callable[[Frame], None]] = None,
    ):
        super().__init__(name)
        self.collect = collect in (True, "true", "TRUE", "1")
        self.callback = callback
        self.frames: List[Frame] = []
        self.num_frames = 0

    def process(self, pad: Pad, frame: Frame):
        del pad
        self.num_frames += 1
        if self.collect:
            self.frames.append(frame)
        if self.callback is not None:
            self.callback(frame)
        return None

    def start(self) -> None:
        super().start()
        self.frames = []
        self.num_frames = 0
