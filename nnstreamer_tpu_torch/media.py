"""Media stream specs: the non-tensor side of converter negotiation.

The port's copy of ``VideoSpec`` from the JAX package's ``media.py``:
``video/x-raw`` frames arrive as (height, width, channels) uint8.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

from .spec import TensorSpec, TensorsSpec

VIDEO_FORMATS = {
    "RGB": 3,
    "BGR": 3,
    "RGBA": 4,
    "BGRA": 4,
    "BGRx": 4,
    "GRAY8": 1,
}


@dataclasses.dataclass(frozen=True)
class VideoSpec:
    """``video/x-raw``: frames arrive as (height, width, channels) uint8."""

    format: str = "RGB"
    width: Optional[int] = None
    height: Optional[int] = None
    rate: Optional[Fraction] = None

    def __post_init__(self):
        if self.format not in VIDEO_FORMATS:
            raise ValueError(f"unsupported video format: {self.format}")
        if self.rate is not None:
            object.__setattr__(self, "rate", Fraction(self.rate))

    @property
    def channels(self) -> int:
        return VIDEO_FORMATS[self.format]

    def tensor_spec(self, frames_per_tensor: int = 1) -> TensorsSpec:
        """NNS dims ``channels:width:height:frames`` as numpy shape
        ``(frames, height, width, channels)``, squeezed to (h, w, c) for one
        frame."""
        shape: Tuple[Optional[int], ...] = (self.height, self.width, self.channels)
        if frames_per_tensor != 1:
            shape = (frames_per_tensor,) + shape
        rate = None
        if self.rate is not None:
            rate = self.rate / frames_per_tensor if frames_per_tensor != 1 else self.rate
        return TensorsSpec(
            tensors=(TensorSpec(dtype=np.uint8, shape=shape),), rate=rate
        )
