"""``direct_video`` decoder: a tensor with video semantics to raw video.

The port of the JAX package's ``decoders/direct_video.py``, the analog of
``tensordec-directvideo.c``: the inverse of the converter for uint8 image
tensors.  Channels 1/3/4 map to GRAY8/RGB/RGBA (``option1`` may force a
format name); ``meta["media"]`` gets the port's :class:`VideoSpec`.  The
frame's tensor is handed on where it lies, a card tensor on the card.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..buffer import Frame
from ..elements.decoder import DecoderPlugin, register_decoder
from ..media import VideoSpec
from ..spec import TensorSpec, TensorsSpec

_FMT_BY_CHANNELS = {1: "GRAY8", 3: "RGB", 4: "RGBA"}


@register_decoder("direct_video")
class DirectVideo(DecoderPlugin):
    def init(self, options: List[str]) -> None:
        self.format = options[0] if options else ""

    def out_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        t = in_spec.tensors[0]
        if t.dtype != np.uint8:
            raise ValueError(f"direct_video needs uint8 input, got {t}")
        if t.rank not in (2, 3):
            raise ValueError(f"direct_video needs (h,w[,c]) input, got {t}")
        ch = 1 if t.rank == 2 else t.shape[-1]
        if ch not in _FMT_BY_CHANNELS:
            raise ValueError(f"direct_video: unsupported channel count {ch}")
        h, w = t.shape[0], t.shape[1]
        shape = (h, w, ch) if ch != 1 else (h, w)
        return TensorsSpec(tensors=(TensorSpec(dtype=np.uint8, shape=shape),), rate=in_spec.rate)

    def decode(self, frame: Frame, in_spec: TensorsSpec) -> Frame:
        t = frame.tensor(0)
        ch = 1 if t.dim() == 2 else t.shape[-1]
        fmt = self.format or _FMT_BY_CHANNELS[ch]
        h, w = t.shape[0], t.shape[1]
        video = VideoSpec(format=fmt if fmt in ("RGB", "RGBA", "GRAY8", "BGR") else "RGB",
                          width=int(w), height=int(h), rate=in_spec.rate)
        out = frame.with_tensors((t,))
        out.meta["media"] = video
        return out
