"""Test sources: ``videotestsrc`` and ``datasrc``.

``videotestsrc`` yields the same frames, bit for bit, as the JAX package's
element for the smpte, random, black and white patterns (the arrays are made
with numpy, as there, and handed over as host tensors).  ``datasrc`` replays
a supplied list of arrays or frames.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..buffer import NONE_TS, SECOND, Frame
from ..graph.node import SourceNode
from ..graph.registry import register_element
from ..media import VideoSpec
from ..spec import TensorsSpec


@register_element("videotestsrc")
class VideoTestSrc(SourceNode):
    """Deterministic (height, width, channels) uint8 host frames.

    ``pattern``: "smpte" (gradient plus a frame counter), "black", "white",
    "random" (seeded per frame).
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
        seed: int = 0,
    ):
        super().__init__(name)
        self.num_buffers = int(num_buffers)
        self.pattern = pattern
        self.video = VideoSpec(
            format=format, width=int(width), height=int(height),
            rate=Fraction(framerate),
        )
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
            yield Frame.of(
                torch.from_numpy(self._make_frame(idx)),
                pts=idx * dur,
                duration=dur,
                media=self.video,
            )
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
