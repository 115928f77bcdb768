"""``filesrc`` / ``filesink``: raw-byte file endpoints.

The port of the JAX package's ``elements/file_io.py``.  ``filesrc`` reads
``location`` as uint8 host chunks of ``blocksize`` bytes (-1: the whole
file as one frame; a trailing partial chunk is dropped, as raw frame
streams want), or a ``.npy`` file as one typed tensor.  ``filesink``
appends the raw C-order bytes of every tensor in arrival order, a card
tensor read to the host once; ``buffer-mode`` is taken for the
reference's property and, as there, changes nothing.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch

from ..buffer import Frame, tensor_bytes
from ..graph.node import Pad, SinkTerminal, SourceNode
from ..graph.registry import register_element
from ..spec import TensorSpec, TensorsSpec


@register_element("filesrc")
class FileSrc(SourceNode):
    def __init__(self, name: Optional[str] = None, location: str = "", blocksize: int = -1,
                 num_buffers: int = -1):
        super().__init__(name)
        if not location:
            raise ValueError("filesrc requires location=")
        self.location = os.fspath(location)
        self.blocksize = int(blocksize)
        self.num_buffers = int(num_buffers)
        self._is_npy = self.location.endswith(".npy")

    def output_spec(self) -> TensorsSpec:
        if self._is_npy:
            arr = np.load(self.location, mmap_mode="r")
            return TensorsSpec.of(TensorSpec(dtype=arr.dtype, shape=tuple(arr.shape)))
        size = os.path.getsize(self.location)
        n = size if self.blocksize <= 0 else self.blocksize
        return TensorsSpec.of(TensorSpec(dtype=np.uint8, shape=(n,)))

    def frames(self) -> Iterable[Frame]:
        if self._is_npy:
            yield Frame.of(torch.from_numpy(np.load(self.location)))
            return
        with open(self.location, "rb") as f:
            idx = 0
            while self.num_buffers < 0 or idx < self.num_buffers:
                if self.stopped:
                    return
                chunk = f.read(-1 if self.blocksize <= 0 else self.blocksize)
                if not chunk:
                    return
                if 0 < self.blocksize and len(chunk) < self.blocksize:
                    return  # the trailing partial chunk
                yield Frame.of(torch.frombuffer(bytearray(chunk), dtype=torch.uint8))
                if self.blocksize <= 0:
                    return
                idx += 1


@register_element("filesink")
class FileSink(SinkTerminal):
    def __init__(self, name: Optional[str] = None, location: str = "",
                 buffer_mode: str = "unbuffered"):
        super().__init__(name)
        del buffer_mode
        if not location:
            raise ValueError("filesink requires location=")
        self.location = os.fspath(location)
        self._f = None
        self.num_frames = 0

    def start(self) -> None:
        super().start()
        self._f = open(self.location, "wb")
        self.num_frames = 0

    def process(self, pad: Pad, frame: Frame):
        del pad
        for t in frame.tensors:
            self._f.write(tensor_bytes(t))
        self.num_frames += 1
        return None

    def drain(self):
        if self._f is not None:
            self._f.flush()
        return None

    def stop(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        super().stop()
