"""``tensor_split``: one tensor sliced into N tensors along one dimension.

The port of the JAX package's ``elements/split.py``: ``tensorseg`` gives
each output's NNS dims (``d1:d2:d3:d4``, comma separated); the outputs
differ from the input along one axis only, whose sizes set the offsets.
``tensorpick`` selects a subset of the segments.  Each output is a view of
the input tensor, where it lies.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..buffer import Frame
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..spec import TensorSpec, TensorsSpec


@register_element("tensor_split")
class TensorSplit(Node):
    REQUEST_SRC_PADS = True

    def __init__(self, name: Optional[str] = None, tensorseg: str = "", tensorpick: str = ""):
        super().__init__(name)
        self.add_sink_pad("sink")
        if not tensorseg:
            raise ValueError("tensor_split requires tensorseg=")
        self.segments: List[TensorSpec] = [
            TensorSpec.from_dims_string(s) for s in str(tensorseg).split(",") if s]
        self.tensorpick: Optional[List[int]] = None
        if tensorpick:
            self.tensorpick = [int(x) for x in str(tensorpick).split(",")]
        self._axis = 0
        self._offsets: List[slice] = []

    def _pad_order(self) -> List[str]:
        return sorted(self.src_pads, key=lambda n: (len(n), n))

    def _selected(self) -> List[int]:
        return self.tensorpick if self.tensorpick is not None else list(range(len(self.segments)))

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        if spec.num_tensors != 1:
            raise NegotiationError(f"{self.name}: split input must be single-tensor")
        t = spec.tensors[0]
        rank = t.rank
        segs = []
        for s in self.segments:
            shape = s.shape
            if len(shape) < rank:  # squeezed trailing NNS 1s: leading 1s here
                shape = (1,) * (rank - len(shape)) + shape
            elif len(shape) > rank:
                raise NegotiationError(f"{self.name}: segment rank > input rank")
            segs.append(TensorSpec(dtype=t.dtype, shape=shape))
        axis = None
        for ax in range(rank):  # the one axis along which the segments tile
            total = sum(s.shape[ax] for s in segs)
            if all(s.shape[a] == t.shape[a] for s in segs for a in range(rank) if a != ax) \
                    and total == t.shape[ax]:
                axis = ax
                break
        if axis is None:
            raise NegotiationError(
                f"{self.name}: tensorseg {self.segments} does not tile input {t}")
        self._axis = axis
        self._offsets = []
        pos = 0
        for s in segs:
            self._offsets.append(slice(pos, pos + s.shape[axis]))
            pos += s.shape[axis]
        sel = self._selected()
        order = self._pad_order()
        if len(order) > len(sel):
            raise NegotiationError(f"{self.name}: more src pads than selected segments")
        return {pad_name: TensorsSpec(tensors=(segs[sel[i]],), rate=spec.rate)
                for i, pad_name in enumerate(order)}

    def process(self, pad: Pad, frame: Frame):
        del pad
        arr = torch.as_tensor(frame.tensor(0))
        sel = self._selected()
        out = []
        for i, pad_name in enumerate(self._pad_order()):
            sl = [slice(None)] * arr.dim()
            sl[self._axis] = self._offsets[sel[i]]
            out.append((pad_name, Frame.of(arr[tuple(sl)], pts=frame.pts,
                                           duration=frame.duration)))
        return out
