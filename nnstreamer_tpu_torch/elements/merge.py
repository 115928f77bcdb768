"""``tensor_merge``: N single-tensor streams → one tensor, concatenated.

The port of the JAX package's ``elements/merge.py`` (mode ``linear``),
with the mux's collection and time sync (:class:`~.collect.CollectNode`).
``option`` is the NNS dimension (0 = innermost) to concatenate along, the
axis ``rank - 1 - option`` of the tensors.  The concatenation runs where
the tensors lie (``torch.cat``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..buffer import Frame
from ..graph.node import NegotiationError
from ..graph.registry import register_element
from ..spec import TensorSpec, TensorsSpec
from .collect import CollectNode


@register_element("tensor_merge")
class TensorMerge(CollectNode):
    def __init__(self, name: Optional[str] = None, mode: str = "linear", option: str = "0",
                 sync_mode: str = "slowest", sync_option: str = ""):
        super().__init__(name, sync_mode=sync_mode, sync_option=sync_option)
        if mode != "linear":
            raise ValueError(f"tensor_merge supports mode=linear, got {mode!r}")
        self.mode = mode
        self.nns_dim = int(option)
        self._axis = 0  # the tensors' axis, set by configure

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        order = sorted(in_specs, key=lambda n: (len(n), n))
        specs = []
        rate = None
        for name in order:
            s = in_specs[name]
            if s.num_tensors != 1:
                raise NegotiationError(f"{self.name}: merge inputs must be single-tensor")
            specs.append(s.tensors[0])
            if s.rate is not None:
                rate = s.rate if rate is None else min(rate, s.rate)
        first = specs[0]
        rank = first.rank
        if any(t.rank != rank for t in specs):
            raise NegotiationError(f"{self.name}: merge inputs must share rank")
        if any(t.dtype != first.dtype for t in specs):
            raise NegotiationError(f"{self.name}: merge inputs must share dtype")
        if self.nns_dim >= rank:
            raise NegotiationError(f"{self.name}: merge dim {self.nns_dim} out of rank {rank}")
        self._axis = rank - 1 - self.nns_dim
        out_dim = 0
        for t in specs:
            for ax, (a, b) in enumerate(zip(t.shape, first.shape)):
                if ax != self._axis and a != b:
                    raise NegotiationError(f"{self.name}: non-merge dims differ: {t} vs {first}")
            out_dim += t.shape[self._axis]
        shape = tuple(out_dim if ax == self._axis else d for ax, d in enumerate(first.shape))
        return {"src": TensorsSpec(tensors=(TensorSpec(dtype=first.dtype, shape=shape),),
                                   rate=rate)}

    def combine(self, frames: Dict[str, Frame]) -> Optional[Frame]:
        order = sorted(frames, key=lambda n: (len(n), n))
        merged = torch.cat([torch.as_tensor(frames[n].tensor(0)) for n in order], dim=self._axis)
        pts, dur = self.output_timing(frames)
        return Frame.of(merged, pts=pts, duration=dur)
