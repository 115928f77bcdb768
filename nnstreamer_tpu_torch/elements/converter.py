"""``tensor_converter``: media streams → tensor streams (video path).

The port's copy of the JAX element's video path: a raw (H, W, C) frame
passes through as a tensor, with 4-byte raster stride padding sliced off
(``meta["stride"]``), ``frames_per_tensor`` frames stacked on a new leading
axis, and missing timestamps synthesized from the input rate.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional

import torch

from ..buffer import NONE_TS, SECOND, Frame, is_valid_ts
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..media import VideoSpec
from ..spec import TensorSpec, TensorsSpec


@register_element("tensor_converter")
class TensorConverter(Node):
    def __init__(self, name: Optional[str] = None, frames_per_tensor: int = 1):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.frames_per_tensor = int(frames_per_tensor)
        if self.frames_per_tensor < 1:
            raise ValueError("frames-per-tensor must be >= 1")
        # The JAX element's input-format and input-dim options, which the
        # port does not take yet; the segment planner reads them to tell a
        # trivial converter (graph/segments.py::_trivial_converter).
        self.input_format = ""
        self.input_spec = None
        self._in_rate: Optional[Fraction] = None
        self._adapter: List[Frame] = []
        self._frame_idx = 0

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        in_spec = in_specs["sink"]
        if len(in_spec.tensors) != 1:
            raise NegotiationError(f"{self.name}: converter input must be single-tensor")
        t = in_spec.tensors[0]
        rate = in_spec.rate
        if self.frames_per_tensor != 1:
            t = TensorSpec(dtype=t.dtype, shape=(self.frames_per_tensor,) + t.shape)
            if rate:
                rate = rate / self.frames_per_tensor
        self._in_rate = in_spec.rate
        self._adapter = []
        self._frame_idx = 0
        return {"src": TensorsSpec(tensors=(t,), rate=rate)}

    def _synthesize_ts(self, frame: Frame) -> Frame:
        """Fill a missing PTS/duration from the input frame rate."""
        if is_valid_ts(frame.pts) or not self._in_rate:
            return frame
        dur = int(SECOND / self._in_rate)
        return Frame(tensors=frame.tensors, pts=self._frame_idx * dur,
                     duration=dur, meta=frame.meta)

    def process(self, pad: Pad, frame: Frame):
        del pad
        arr = frame.tensor(0)
        if isinstance(frame.meta.get("media"), VideoSpec) and "stride" in frame.meta:
            arr = arr[:, :frame.meta["width"], ...]
        out = self._batch(self._synthesize_ts(frame.with_tensors((arr,))))
        self._frame_idx += 1
        return out

    def _batch(self, frame: Frame):
        if self.frames_per_tensor == 1:
            return [frame]
        self._adapter.append(frame)
        if len(self._adapter) < self.frames_per_tensor:
            return None
        first = self._adapter[0]
        durs = [f.duration for f in self._adapter if is_valid_ts(f.duration)]
        stacked = torch.stack([f.tensor(0) for f in self._adapter], dim=0)
        self._adapter = []
        return [Frame.of(stacked, pts=first.pts, duration=sum(durs) if durs else NONE_TS)]
