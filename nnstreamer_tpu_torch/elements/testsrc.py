"""Test sources: ``videotestsrc``, ``audiotestsrc`` and ``datasrc``.

``videotestsrc`` and ``audiotestsrc`` yield the same frames, bit for bit, as
the JAX package's elements (the arrays are made with numpy, as there, and
handed over as host tensors): video in the smpte, random, black and white
patterns, audio as a sine (float64 ``np.sin``, scaled and cast to the
format's dtype) or silence.  ``datasrc`` replays a supplied list of arrays
or frames.
"""

from __future__ import annotations

import time
from fractions import Fraction
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..buffer import NONE_TS, SECOND, Frame
from ..graph.node import SourceNode
from ..graph.registry import register_element
from ..media import AudioSpec, VideoSpec
from ..spec import TensorSpec, TensorsSpec
from ..utils.props import parse_bool


@register_element("videotestsrc")
class VideoTestSrc(SourceNode):
    """Deterministic (height, width, channels) uint8 host frames.

    ``pattern``: "smpte" (gradient plus a frame counter), "black", "white",
    "random" (seeded per frame).  ``is-live`` sleeps between frames to
    keep the framerate.
    """

    def __init__(
        self,
        name: Optional[str] = None,
        num_buffers: int = -1,
        pattern: str = "smpte",
        width: int = 320,
        height: int = 240,
        format: str = "RGB",
        framerate: str = "30/1",
        is_live: bool = False,
        seed: int = 0,
    ):
        super().__init__(name)
        self.num_buffers = int(num_buffers)
        self.pattern = pattern
        self.video = VideoSpec(
            format=format, width=int(width), height=int(height),
            rate=Fraction(framerate),
        )
        self.is_live = parse_bool(is_live, name="is-live")
        # a live source sleeps to keep the framerate: a blocking boundary
        # for the dispatcher lanes (graph/lanes.py)
        self.LANE_BLOCKING = self.is_live
        self.seed = int(seed)

    def output_spec(self) -> TensorsSpec:
        return self.video.tensor_spec()

    def _make_frame(self, idx: int) -> np.ndarray:
        h, w, c = self.video.height, self.video.width, self.video.channels
        if self.pattern == "black":
            arr = np.zeros((h, w, c), np.uint8)
        elif self.pattern == "white":
            arr = np.full((h, w, c), 255, np.uint8)
        elif self.pattern == "random":
            rng = np.random.default_rng(self.seed + idx)
            arr = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
        else:  # "smpte"
            y = np.arange(h, dtype=np.uint32)[:, None]
            x = np.arange(w, dtype=np.uint32)[None, :]
            base = ((x * 255) // max(w - 1, 1) + (y * 255) // max(h - 1, 1) + idx) % 256
            arr = np.broadcast_to(base[..., None], (h, w, c)).astype(np.uint8)
        return arr

    def frames(self) -> Iterable[Frame]:
        rate = self.video.rate or Fraction(30)
        dur = int(SECOND / rate)
        idx = 0
        while self.num_buffers < 0 or idx < self.num_buffers:
            if self.stopped:
                return
            if self.is_live and idx:
                time.sleep(float(1 / rate))
            yield Frame.of(
                torch.from_numpy(self._make_frame(idx)),
                pts=idx * dur,
                duration=dur,
                media=self.video,
            )
            idx += 1


@register_element("audiotestsrc")
class AudioTestSrc(SourceNode):
    """Deterministic audio: (samplesperbuffer, channels) host blocks."""

    def __init__(
        self,
        name: Optional[str] = None,
        num_buffers: int = -1,
        samplesperbuffer: int = 1024,
        channels: int = 1,
        rate: int = 16000,
        format: str = "S16LE",
        wave: str = "sine",
        freq: float = 440.0,
    ):
        super().__init__(name)
        self.num_buffers = int(num_buffers)
        self.spb = int(samplesperbuffer)
        self.audio = AudioSpec(format=format, channels=int(channels), sample_rate=int(rate))
        self.wave = wave
        self.freq = float(freq)

    def output_spec(self) -> TensorsSpec:
        return TensorsSpec(
            tensors=(TensorSpec(dtype=self.audio.dtype, shape=(self.spb, self.audio.channels)),),
            rate=Fraction(self.audio.sample_rate, self.spb),
        )

    def _make_block(self, idx: int) -> np.ndarray:
        sr = self.audio.sample_rate
        dtype = self.audio.dtype
        t = (np.arange(self.spb) + idx * self.spb) / sr
        if self.wave == "silence":
            wavef = np.zeros(self.spb)
        else:
            wavef = np.sin(2 * np.pi * self.freq * t)
        if np.issubdtype(dtype, np.integer):
            info = np.iinfo(dtype)
            data = (wavef * min(info.max, -(info.min + 1))).astype(dtype)
        else:
            data = wavef.astype(dtype)
        return np.repeat(data[:, None], self.audio.channels, axis=1)

    def frames(self) -> Iterable[Frame]:
        dur = self.spb * SECOND // self.audio.sample_rate
        idx = 0
        while self.num_buffers < 0 or idx < self.num_buffers:
            if self.stopped:
                return
            yield Frame.of(torch.from_numpy(self._make_block(idx)), pts=idx * dur,
                           duration=dur, media=self.audio)
            idx += 1


@register_element("datasrc")
class DataSrc(SourceNode):
    """Replays a sequence of arrays (numpy or torch) or Frames."""

    def __init__(
        self,
        name: Optional[str] = None,
        data: Optional[Sequence] = None,
        spec: Optional[TensorsSpec] = None,
        rate: Optional[Fraction] = None,
    ):
        super().__init__(name)
        self.data = list(data or [])
        self._spec = spec
        self.rate = Fraction(rate) if rate is not None else Fraction(0)

    def output_spec(self) -> TensorsSpec:
        if self._spec is not None:
            return self._spec.fixate() if not self._spec.is_fixed else self._spec
        if not self.data:
            raise ValueError(f"{self.name}: datasrc needs data or an explicit spec")
        first = self.data[0]
        arrays = first.tensors if isinstance(first, Frame) else (first,)
        return TensorsSpec.from_arrays(arrays, rate=self.rate)

    def frames(self) -> Iterable[Frame]:
        dur = int(SECOND / self.rate) if self.rate else NONE_TS
        for idx, item in enumerate(self.data):
            if self.stopped:
                return
            if isinstance(item, Frame):
                yield item
            else:
                arrays = item if isinstance(item, (tuple, list)) else (item,)
                yield Frame.of(
                    *[torch.as_tensor(a) for a in arrays],
                    pts=idx * dur if dur != NONE_TS else NONE_TS,
                    duration=dur,
                )
