"""``tensor_save`` / ``tensor_load``: typed tensor-stream persistence.

The port of the JAX package's ``elements/save_load.py``; its files are
byte for byte the JAX package's, and each package reads the other's.
``tensor_save`` is a sink that writes a self-describing stream container;
``tensor_load`` replays it as a source with the original specs and
timestamps (golden capture, stream replay).

Container format (``NNSTPU1``): a magic line, then per frame a JSON header
line (pts, duration, each tensor's dtype name and shape, and the frame's
meta) followed by the tensors' raw C-order bytes (a 0-d tensor reads back
as shape ``(1,)``, as in the JAX package).  A meta value that is an
array rides inline as ``{"__nd__": [dtype, shape, base64]}``; any other
value must be JSON-serializable, else the write raises ``TypeError``.
Append-friendly: a truncated tail loses at most the last frame.

A card tensor is read to the host once, at the write; frames and meta
arrays read back are host tensors.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Iterable, Optional

import numpy as np
import torch

from ..buffer import NONE_TS, Frame, tensor_bytes
from ..graph.node import Pad, SinkTerminal, SourceNode
from ..graph.registry import register_element
from ..spec import TensorSpec, TensorsSpec, dtype_from_name, dtype_name, numpy_dtype, torch_dtype

MAGIC = b"NNSTPU1\n"


def _host(v):
    """(dtype name, shape, C-order bytes) of an array-like: a torch tensor
    (on any device) or a numpy array.  A 0-d tensor is written as shape
    ``[1]``, as the JAX package's ``np.ascontiguousarray`` makes it."""
    if isinstance(v, torch.Tensor):
        return dtype_name(v.dtype), [int(d) for d in v.shape] or [1], tensor_bytes(v)
    a = np.ascontiguousarray(np.asarray(v))
    return a.dtype.name, list(a.shape), a.tobytes()


def _tensor(raw: bytes, dtype_s: str, shape) -> torch.Tensor:
    tdt = torch_dtype(dtype_from_name(dtype_s))
    if not raw:
        return torch.empty(0, dtype=tdt).reshape(shape)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(tdt).reshape(shape)


def _encode_meta(meta: dict) -> dict:
    """Frame meta as JSON: arrays inline (base64), plain values as they are."""
    out = {}
    for k, v in meta.items():
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            name, shape, data = _host(v)
            out[k] = {"__nd__": [name, shape, base64.b64encode(data).decode()]}
        else:
            try:
                json.dumps(v)
            except TypeError:
                raise TypeError(f"tensor_save: frame meta[{k!r}] of type "
                                f"{type(v).__name__} is not serializable") from None
            out[k] = v
    return out


def _decode_meta(meta: dict) -> dict:
    out = {}
    for k, v in meta.items():
        if isinstance(v, dict) and "__nd__" in v:
            dtype_s, shape, data = v["__nd__"]
            out[k] = _tensor(base64.b64decode(data), dtype_s, shape)
        else:
            out[k] = v
    return out


def write_frame(f, frame: Frame) -> None:
    """Append one frame (header line, then the tensors' bytes) to ``f``."""
    arrays = [_host(t) for t in frame.tensors]
    header = {
        "pts": frame.pts,
        "duration": frame.duration,
        "tensors": [{"dtype": name, "shape": shape} for name, shape, _ in arrays],
    }
    if frame.meta:
        header["meta"] = _encode_meta(frame.meta)
    f.write(json.dumps(header).encode() + b"\n")
    for _, _, data in arrays:
        f.write(data)


def read_frames(path: str) -> Iterable[Frame]:
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not an NNSTPU1 tensor stream")
        while True:
            line = f.readline()
            if not line:
                return
            try:
                header = json.loads(line)
            except json.JSONDecodeError:
                return  # truncated mid-header: drop the partial frame
            if not isinstance(header, dict) or "tensors" not in header:
                return
            tensors = []
            for t in header["tensors"]:
                itemsize = dtype_from_name(t["dtype"]).itemsize
                count = int(np.prod(t["shape"])) if t["shape"] else 1
                raw = f.read(count * itemsize)
                if len(raw) != count * itemsize:
                    return  # truncated tail: drop the partial frame
                tensors.append(_tensor(raw, t["dtype"], t["shape"]))
            yield Frame(tensors=tuple(tensors), pts=header.get("pts", NONE_TS),
                        duration=header.get("duration", NONE_TS),
                        meta=_decode_meta(header.get("meta", {})))


@register_element("tensor_save")
class TensorSave(SinkTerminal):
    """Persist every arriving frame to ``location``."""

    def __init__(self, name: Optional[str] = None, location: str = ""):
        super().__init__(name)
        if not location:
            raise ValueError("tensor_save requires location=")
        self.location = os.fspath(location)
        self._file = None
        self.num_frames = 0

    def start(self) -> None:
        super().start()
        self._file = open(self.location, "wb")
        self._file.write(MAGIC)
        self.num_frames = 0

    def process(self, pad: Pad, frame: Frame):
        del pad
        write_frame(self._file, frame)
        self.num_frames += 1
        return None

    def drain(self):
        if self._file is not None:
            self._file.flush()
        return None

    def stop(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        super().stop()


@register_element("tensor_load")
class TensorLoad(SourceNode):
    """Replay a saved tensor stream; the specs come from the first frame's
    header (every frame must share them, as a negotiated stream does)."""

    def __init__(self, name: Optional[str] = None, location: str = "", num_buffers: int = -1):
        super().__init__(name)
        if not location:
            raise ValueError("tensor_load requires location=")
        self.location = os.fspath(location)
        self.num_buffers = int(num_buffers)

    def output_spec(self) -> TensorsSpec:
        for frame in read_frames(self.location):
            return TensorsSpec(tensors=tuple(
                TensorSpec(dtype=numpy_dtype(t.dtype), shape=tuple(t.shape))
                for t in frame.tensors))
        raise ValueError(f"{self.location}: empty tensor stream")

    def frames(self) -> Iterable[Frame]:
        for i, frame in enumerate(read_frames(self.location)):
            if self.stopped or 0 <= self.num_buffers <= i:
                return
            yield frame
