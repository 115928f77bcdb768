"""``tensor_if``: route frames by a condition on their tensor values.

The port of the JAX package's ``elements/tensor_if.py`` (upstream's
``tensor_if``):

- ``compared-value``: ``max`` | ``min`` | ``mean`` | ``abs-max`` |
  ``element:<flat-index>``, reduced over the input tensor ``tensor=k``
  (default 0);
- ``op``: ``>`` ``>=`` ``<`` ``<=`` ``==`` ``!=``; ``threshold``: a float;
- ``then`` / ``else`` (or ``else_``): ``pass`` | ``drop``.

The deciding tensor is read to the host (for a card tensor, one small
device-to-host copy a frame: keep it small, scores rather than images),
and reduced as the JAX package reduces its numpy array: numpy itself for
every dtype numpy has (float32's mean is numpy's pairwise float32 sum),
and for bfloat16 what ``ml_dtypes``' mean computes, a sequential sum
rounded to bfloat16 after each float32 add, divided by the count in
float64 and rounded to bfloat16 (:func:`bfloat16_mean`).  A value on the
threshold takes the same branch in both packages.

Counters ``passed`` / ``dropped``; each frame passed on gets
``meta["tensor_if"] = {"value": v, "result": bool}``.
"""

from __future__ import annotations

import operator
import struct
from typing import Dict, Optional

import numpy as np
import torch

from ..buffer import Frame
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..spec import TensorsSpec

_OPS = {
    ">": operator.gt, ">=": operator.ge, "<": operator.lt,
    "<=": operator.le, "==": operator.eq, "!=": operator.ne,
}
_F32 = struct.Struct("<f")
_U32 = struct.Struct("<I")


def _round_bf16(x: float) -> float:
    """float32(x) rounded to bfloat16, to nearest even (a NaN stays NaN)."""
    bits = _U32.unpack(_F32.pack(x))[0]
    if bits & 0x7F800000 == 0x7F800000 and bits & 0x7FFFFF:
        return x
    bits = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return _F32.unpack(_U32.pack(bits & 0xFFFFFFFF))[0]


def bfloat16_mean(t: torch.Tensor) -> float:
    """The mean of a bfloat16 host tensor as ``ml_dtypes`` computes it
    under numpy: the add reduction runs in C order from the first element,
    each step a float32 add rounded to bfloat16; the sum divided by the
    count in float64 is then rounded to bfloat16."""
    vals = t.reshape(-1).float().tolist()
    acc = vals[0]
    for v in vals[1:]:
        # both operands are bfloat16 values: their float64 sum rounded
        # to float32 is their float32 sum
        acc = _round_bf16(acc + v)
    return float(torch.tensor(acc / len(vals), dtype=torch.float64).to(torch.bfloat16))


def _reducer(cv: str):
    """(numpy reduction, bfloat16 torch reduction) of ``compared-value``."""
    if cv == "max":
        return lambda a: float(a.max()), lambda t: float(t.max())
    if cv == "min":
        return lambda a: float(a.min()), lambda t: float(t.min())
    if cv == "mean":
        return lambda a: float(a.mean()), bfloat16_mean
    if cv == "abs-max":
        return lambda a: float(np.abs(a).max()), lambda t: float(t.abs().max())
    if cv.startswith("element:"):
        idx = int(cv.split(":", 1)[1])
        if idx < 0:
            raise ValueError(f"element index must be >= 0, got {idx}")
        return (lambda a: float(a.reshape(-1)[idx]),
                lambda t: float(t.reshape(-1)[idx]))
    raise ValueError(f"unknown compared_value {cv!r} (max|min|mean|abs-max|element:<i>)")


@register_element("tensor_if")
class TensorIf(Node):
    def __init__(self, name: Optional[str] = None, compared_value: str = "max", op: str = ">",
                 threshold: float = 0.5, then: str = "pass", else_: str = "drop",
                 tensor: int = 0, **aliases):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        # parse_launch spells the else branch `else=...`
        if "else" in aliases:
            else_ = aliases.pop("else")
        if aliases:
            raise TypeError(f"unknown properties {sorted(aliases)}")
        self.compared_value = str(compared_value)
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r}; known: {sorted(_OPS)}")
        self.op = op
        self.threshold = float(threshold)
        for action, label in ((then, "then"), (else_, "else")):
            if action not in ("pass", "drop"):
                raise ValueError(f"{label} action must be pass|drop, got {action!r}")
        self.then_action = then
        self.else_action = else_
        self.tensor = int(tensor)
        if self.tensor < 0:
            raise ValueError(f"tensor index must be >= 0, got {self.tensor}")
        self.passed = 0
        self.dropped = 0
        self._reduce, self._reduce_bf16 = _reducer(self.compared_value)

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        if self.tensor >= spec.num_tensors:
            raise NegotiationError(f"{self.name}: tensor={self.tensor} but frames carry "
                                   f"{spec.num_tensors}")
        t = spec.tensors[self.tensor]
        if self.compared_value.startswith("element:") and t.is_fixed:
            idx = int(self.compared_value.split(":", 1)[1])
            if idx >= t.num_elements:
                raise NegotiationError(f"{self.name}: element:{idx} out of range for "
                                       f"{t.num_elements}-element tensor {t}")
        return {"src": spec}

    def value(self, t) -> float:
        """The compared value of one tensor (read to the host)."""
        host = torch.as_tensor(t).detach().cpu()
        if host.dtype == torch.bfloat16:
            return self._reduce_bf16(host)
        return self._reduce(host.numpy())

    def process(self, pad: Pad, frame: Frame):
        del pad
        value = self.value(frame.tensors[self.tensor])
        result = _OPS[self.op](value, self.threshold)
        if (self.then_action if result else self.else_action) == "drop":
            self.dropped += 1
            return None
        self.passed += 1
        meta = dict(frame.meta)
        meta["tensor_if"] = {"value": value, "result": bool(result)}
        return frame.with_tensors(frame.tensors, meta=meta)
