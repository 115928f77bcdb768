"""``tensor_sink`` and ``fakesink``: the stream's terminals.

``tensor_sink`` is the application-facing one, the port of the JAX
element: ``connect("new-data", cb)`` calls ``cb(frame)`` for each frame and
``connect("eos", cb)`` calls ``cb()`` at the end of the stream, a
``signal-rate`` above 0 limits the ``new-data`` calls per second, ``collect``
keeps the frames in :attr:`TensorSink.frames`, and :meth:`TensorSink.wait_eos`
blocks until the stream has ended.  ``sync`` is taken for the reference's
property and, as there, changes nothing.  ``fakesink`` counts and drops
frames.

A frame that ``tensor_upload`` sent straight here holds tensors whose copy
may still be running on the upload's stream; the node's dispatch makes the
current stream wait for it before :meth:`TensorSink.process` (and so any
callback) runs (``graph/node.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ..buffer import Frame
from ..graph.node import Pad, SinkTerminal
from ..graph.registry import register_element
from ..utils.props import parse_bool


@register_element("tensor_sink")
class TensorSink(SinkTerminal):
    def __init__(
        self,
        name: Optional[str] = None,
        signal_rate: int = 0,
        collect: bool = False,
        sync: bool = False,
        callback: Optional[Callable[[Frame], None]] = None,
    ):
        super().__init__(name)
        self.signal_rate = int(signal_rate)
        self.collect = parse_bool(collect, name="collect")
        self.sync = parse_bool(sync, name="sync")
        self.callbacks: List[Callable[[Frame], None]] = []
        self.eos_callbacks: List[Callable[[], None]] = []
        if callback is not None:
            self.callbacks.append(callback)
        self.frames: List[Frame] = []
        self.num_frames = 0
        self._last_signal_ns = 0
        self._eos_evt = threading.Event()

    def connect(self, signal: str, callback: Callable) -> None:
        """Connect a callback to ``"new-data"`` or ``"eos"``."""
        if signal == "new-data":
            self.callbacks.append(callback)
        elif signal == "eos":
            self.eos_callbacks.append(callback)
        else:
            raise ValueError(f"unknown signal {signal!r}")

    def process(self, pad: Pad, frame: Frame):
        del pad
        self.num_frames += 1
        if self.signal_rate > 0:
            now = time.monotonic_ns()
            if now - self._last_signal_ns < 1_000_000_000 // self.signal_rate:
                return None
            self._last_signal_ns = now
        if self.collect:
            self.frames.append(frame)
        for cb in self.callbacks:
            cb(frame)
        return None

    def drain(self):
        self._eos_evt.set()
        for cb in self.eos_callbacks:
            cb()
        return None

    def wait_eos(self, timeout: Optional[float] = None) -> bool:
        return self._eos_evt.wait(timeout)

    def start(self) -> None:
        super().start()
        self.frames = []
        self.num_frames = 0
        self._eos_evt.clear()


@register_element("fakesink")
class FakeSink(SinkTerminal):
    """Counts and drops every frame."""

    def __init__(self, name: Optional[str] = None, **_ignored):
        super().__init__(name)
        self.num_frames = 0

    def process(self, pad: Pad, frame: Frame):
        del pad, frame
        self.num_frames += 1
        return None
