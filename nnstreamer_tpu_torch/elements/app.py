"""``appsrc`` / ``appsink``: the bridge between an application and a
pipeline.

The port of the JAX package's ``elements/app.py``, what the reference's C
API feeds and drains pipelines through: ``ml_pipeline_src_input_data``
pushes into an appsrc (``nnstreamer.h:403``,
``nnstreamer-capi-pipeline.c``) and sink callbacks hang off
appsink/tensor_sink signals (``:246-254,813-825``).

:meth:`AppSrc.push_frame` takes a frame of torch tensors or numpy arrays;
a numpy array becomes a tensor over the same memory (``torch.as_tensor``),
so nothing is copied here.  A host frame reaches the card through
``tensor_upload`` downstream, as every source's does.  :class:`AppSink`
hands each frame on as it is: a tensor pulled from it stays on the device
where it lives.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ..buffer import Frame
from ..graph.node import Pad, SinkTerminal, SourceNode
from ..graph.registry import register_element
from ..spec import TensorsSpec
from ..utils.props import parse_bool


def _as_tensor(t):
    return t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))


@register_element("appsrc")
class AppSrc(SourceNode):
    """Push source fed by the application through :meth:`push_frame`.

    The output spec comes from the ``caps`` property (a caps string or a
    :class:`TensorsSpec`) or from :meth:`set_spec` before the start.
    """

    LANE_BLOCKING = True  # frames() waits on the application's push queue

    def __init__(self, name: Optional[str] = None, caps: Optional[str] = None,
                 max_buffers: int = 100):
        super().__init__(name)
        self._spec: Optional[TensorsSpec] = None
        if caps is not None:
            self.set_spec(caps)
        self._q: _queue.Queue = _queue.Queue(maxsize=int(max_buffers))

    def set_spec(self, spec) -> None:
        if isinstance(spec, str):
            spec = TensorsSpec.from_caps_string(spec)
        self._spec = spec

    def output_spec(self) -> TensorsSpec:
        if self._spec is None:
            raise ValueError(f"{self.name}: appsrc needs caps/set_spec before start")
        return self._spec.fixate()

    def push_frame(self, frame: Frame, timeout: Optional[float] = None) -> None:
        """Application thread: enqueue one frame (blocks while the queue is
        full)."""
        self._q.put(frame.with_tensors(tuple(_as_tensor(t) for t in frame.tensors)),
                    timeout=timeout)

    def end_of_stream(self) -> None:
        self._q.put(None)

    def frames(self):
        while not self.stopped:
            try:
                item = self._q.get(timeout=0.1)
            except _queue.Empty:
                continue
            if item is None:
                return
            yield item

    def interrupt(self) -> None:
        self.request_stop()


@register_element("appsink")
class AppSink(SinkTerminal):
    """Pull sink: the application pops frames with :meth:`pull`, or
    registers a ``new-data`` callback (emit-signals mode)."""

    def __init__(self, name: Optional[str] = None, max_buffers: int = 100,
                 drop: bool = False):
        super().__init__(name)
        self.max_buffers = int(max_buffers)
        self.drop = parse_bool(drop, name="drop")
        self._q: _queue.Queue = _queue.Queue()
        self.callbacks: List[Callable[[Frame], None]] = []
        self._eos = threading.Event()
        self.num_frames = 0

    def connect(self, signal: str, callback: Callable) -> None:
        if signal != "new-data":
            raise ValueError(f"unknown signal {signal!r}")
        self.callbacks.append(callback)

    def process(self, pad: Pad, frame: Frame):
        del pad
        self.num_frames += 1
        if self.callbacks:
            for cb in self.callbacks:
                cb(frame)
            return None
        if self.drop and self._q.qsize() >= self.max_buffers:
            try:
                self._q.get_nowait()
            except _queue.Empty:
                pass
        self._q.put(frame)
        return None

    def drain(self):
        self._eos.set()
        return None

    def pull(self, timeout: Optional[float] = None) -> Optional[Frame]:
        """Pop the next frame; None at EOS (or after ``timeout`` seconds)."""
        while True:
            try:
                return self._q.get(timeout=0.05 if timeout is None else timeout)
            except _queue.Empty:
                if self._eos.is_set() and self._q.empty():
                    return None
                if timeout is not None:
                    return None
