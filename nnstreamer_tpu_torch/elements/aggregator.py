"""``tensor_aggregator``: windows of frames along one dimension.

The port of the JAX element (GStreamer's adapter semantics: accumulate,
emit, flush):

- ``frames_in``    frames held by each incoming buffer along ``frames_dim``
  (the axis length must divide by it);
- ``frames_out``   frames per outgoing buffer, concatenated along
  ``frames_dim``;
- ``frames_flush`` frames dropped after each output; 0 means
  ``frames_out`` (a tumbling window), fewer than ``frames_out`` a sliding
  window with overlap;
- ``frames_dim``   the NNS dimension index (innermost first, the reverse of
  numpy's order) to window along: for (1600, 1) audio blocks, dim 1 is the
  sample axis.  A dim past the tensor's rank stacks frames on a new
  leading axis.

``concat`` is taken for the reference's property; windows are always
concatenated, as there.  The window works on whatever device its frames
are on.  :meth:`TensorAggregator.state_dict` / :meth:`load_state` save and
restore the pending window.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

import torch

from ..buffer import NONE_TS, Frame, is_valid_ts
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..spec import TensorSpec, TensorsSpec
from ..utils.props import parse_bool

_NEW_AXIS = -1  # frames_dim past the rank: stack on a new leading axis


@register_element("tensor_aggregator")
class TensorAggregator(Node):
    def __init__(
        self,
        name: Optional[str] = None,
        frames_in: int = 1,
        frames_out: int = 1,
        frames_flush: int = 0,
        frames_dim: int = 3,
        concat: bool = True,
    ):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.frames_in = int(frames_in)
        self.frames_out = int(frames_out)
        self.frames_flush = int(frames_flush) or self.frames_out
        self.nns_dim = int(frames_dim)
        self.concat = parse_bool(concat, name="concat")
        if self.frames_in < 1 or self.frames_out < 1 or self.frames_flush < 1:
            raise ValueError("frames-in/out/flush must be >= 1")
        self._axis = 0
        self._window: collections.deque = collections.deque()
        self._timing: collections.deque = collections.deque()
        self._keep_state_on_start = False

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        if spec.num_tensors != 1:
            raise NegotiationError(f"{self.name}: aggregator input must be single-tensor")
        t = spec.tensors[0]
        if self.nns_dim >= t.rank:
            # NNS pads the rank to 4 with trailing 1s: a window along a
            # padded dim stacks on a new leading numpy axis
            if self.frames_in != 1:
                raise NegotiationError(
                    f"{self.name}: frames-in>1 needs an explicit frames dim in input")
            self._axis = _NEW_AXIS
            out_shape = (self.frames_out,) + t.shape
        else:
            self._axis = t.rank - 1 - self.nns_dim
            if t.shape[self._axis] % self.frames_in:
                raise NegotiationError(
                    f"{self.name}: input dim {t.shape[self._axis]} not divisible "
                    f"by frames-in={self.frames_in}")
            unit_len = t.shape[self._axis] // self.frames_in
            out_shape = tuple(unit_len * self.frames_out if ax == self._axis else d
                              for ax, d in enumerate(t.shape))
        rate = spec.rate
        if rate:
            rate = rate * self.frames_in / self.frames_flush
        if self._keep_state_on_start:
            self._keep_state_on_start = False  # resuming: keep the restored window
        else:
            self._window.clear()
            self._timing.clear()
        return {"src": TensorsSpec(tensors=(TensorSpec(dtype=t.dtype, shape=out_shape),),
                                   rate=rate)}

    def _split_units(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self._axis == _NEW_AXIS or self.frames_in == 1:
            return [x]
        return list(torch.chunk(x, self.frames_in, dim=self._axis))

    def _emit_window(self) -> Frame:
        # units restored by load_state lie on the host: join them where the
        # stream's frames are
        dev = self._window[self.frames_out - 1].device
        units = [self._window[i].to(dev) for i in range(self.frames_out)]
        if self._axis == _NEW_AXIS:
            out = torch.stack(units, dim=0)
        elif len(units) == 1:
            out = units[0]
        else:
            out = torch.cat(units, dim=self._axis)
        pts = self._timing[0][0]
        durs = [d for (_, d) in list(self._timing)[: self.frames_out] if is_valid_ts(d)]
        for _ in range(min(self.frames_flush, len(self._window))):
            self._window.popleft()
            self._timing.popleft()
        return Frame.of(out, pts=pts, duration=sum(durs) if durs else NONE_TS)

    def process(self, pad: Pad, frame: Frame):
        del pad
        units = self._split_units(frame.tensor(0))
        per_dur = frame.duration
        if is_valid_ts(per_dur) and len(units) > 1:
            per_dur //= len(units)
        for i, u in enumerate(units):
            pts = frame.pts
            if is_valid_ts(pts) and is_valid_ts(per_dur):
                pts += i * per_dur
            self._window.append(u)
            self._timing.append((pts, per_dur))
        out = []
        while len(self._window) >= self.frames_out:
            out.append(self._emit_window())
        return out or None

    def start(self) -> None:
        super().start()
        if not self._keep_state_on_start:
            self._window.clear()
            self._timing.clear()

    def state_dict(self) -> dict:
        """The pending window: its units (host tensors) and their timing."""
        return {"window": [u.detach().cpu() for u in self._window],
                "timing": [list(t) for t in self._timing]}

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`state_dict`; the next start keeps it."""
        self._window = collections.deque(torch.as_tensor(u) for u in state["window"])
        self._timing = collections.deque((int(p), int(d)) for p, d in state["timing"])
        self._keep_state_on_start = True
