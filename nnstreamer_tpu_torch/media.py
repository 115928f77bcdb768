"""Media stream specs: the non-tensor side of converter negotiation.

The port's copy of the JAX package's ``media.py``.  Each media kind maps
itself to a tensor spec (:meth:`tensor_spec`): ``video/x-raw`` frames are
(height, width, channels) uint8, ``audio/x-raw`` blocks (samples, channels)
of the format's dtype, ``text/x-raw`` a fixed-size uint8 buffer, and
``application/octet-stream`` whatever spec the converter's ``input-dim`` /
``input-type`` declare.
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

AUDIO_FORMATS = {
    "S8": np.dtype(np.int8),
    "U8": np.dtype(np.uint8),
    "S16LE": np.dtype(np.int16),
    "U16LE": np.dtype(np.uint16),
    "S32LE": np.dtype(np.int32),
    "U32LE": np.dtype(np.uint32),
    "F32LE": np.dtype(np.float32),
    "F64LE": np.dtype(np.float64),
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


@dataclasses.dataclass(frozen=True)
class AudioSpec:
    """``audio/x-raw``: blocks arrive as (samples, channels)."""

    format: str = "S16LE"
    channels: Optional[int] = None
    sample_rate: Optional[int] = None

    def __post_init__(self):
        if self.format not in AUDIO_FORMATS:
            raise ValueError(f"unsupported audio format: {self.format}")

    @property
    def dtype(self) -> np.dtype:
        return AUDIO_FORMATS[self.format]

    def tensor_spec(self, frames_per_tensor: int = 1) -> TensorsSpec:
        """NNS dims ``channels:samples``, numpy shape (samples, channels)."""
        rate = None
        if self.sample_rate is not None:
            rate = Fraction(self.sample_rate, frames_per_tensor)
        return TensorsSpec(
            tensors=(TensorSpec(dtype=self.dtype, shape=(frames_per_tensor, self.channels)),),
            rate=rate,
        )


@dataclasses.dataclass(frozen=True)
class TextSpec:
    """``text/x-raw``: utf-8 text in a null-padded uint8 buffer of ``size``
    bytes (the converter needs ``input-dim`` for text)."""

    size: Optional[int] = None

    def tensor_spec(self, frames_per_tensor: int = 1) -> TensorsSpec:
        del frames_per_tensor
        return TensorsSpec(tensors=(TensorSpec(dtype=np.uint8, shape=(self.size,)),))


@dataclasses.dataclass(frozen=True)
class OctetSpec:
    """``application/octet-stream``: opaque bytes, read through the tensor
    spec the converter's ``input-dim`` / ``input-type`` declare."""

    spec: Optional[TensorsSpec] = None

    def tensor_spec(self, frames_per_tensor: int = 1) -> TensorsSpec:
        del frames_per_tensor
        if self.spec is None:
            raise ValueError("application/octet-stream requires explicit input-dim/input-type")
        return self.spec


MediaSpec = (VideoSpec, AudioSpec, TextSpec, OctetSpec)
