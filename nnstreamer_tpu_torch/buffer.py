"""Stream buffers: the frames and events that flow through a pipeline.

The port's copy of the JAX package's ``buffer.py``.  A frame's payloads are
torch tensors, on the host (CPU) or on the card; elements that compute on
the card move a host frame there themselves.  :meth:`Frame.to_host` gives
the frame with host tensors (bfloat16 stays a torch tensor: numpy has no
bfloat16).

Timestamps are integer nanoseconds; ``NONE_TS`` marks an absent one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .spec import numpy_dtype

NONE_TS = -1
SECOND = 1_000_000_000  # ns


def is_valid_ts(ts: int) -> bool:
    return ts is not None and ts >= 0


@dataclasses.dataclass
class Frame:
    """One frame on a pad: a tuple of tensors, timing and metadata."""

    tensors: Tuple[Any, ...]
    pts: int = NONE_TS
    duration: int = NONE_TS
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not isinstance(self.tensors, tuple):
            self.tensors = tuple(self.tensors)

    @classmethod
    def of(cls, *tensors, pts: int = NONE_TS, duration: int = NONE_TS, **meta) -> "Frame":
        return cls(tensors=tensors, pts=pts, duration=duration, meta=dict(meta))

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def tensor(self, i: int = 0):
        return self.tensors[i]

    def with_tensors(self, tensors, **updates) -> "Frame":
        """New frame with replaced payloads; timing kept.  ``meta`` is shared
        by reference unless a ``meta=`` update is passed."""
        meta = updates.get("meta")
        return Frame(
            tensors=tuple(tensors),
            pts=updates.get("pts", self.pts),
            duration=updates.get("duration", self.duration),
            meta=dict(meta) if meta is not None else self.meta,
        )

    def to_host(self) -> "Frame":
        """The frame with every payload as a host (CPU) tensor."""
        return self.with_tensors(tuple(torch.as_tensor(t).detach().cpu() for t in self.tensors))

    @property
    def end_ts(self) -> int:
        if is_valid_ts(self.pts) and is_valid_ts(self.duration):
            return self.pts + self.duration
        return NONE_TS

    def __repr__(self) -> str:
        shapes = ",".join(f"{t.dtype}{tuple(t.shape)}" for t in self.tensors)
        return f"Frame[{shapes} pts={self.pts}]"


def tensor_bytes(t) -> bytes:
    """The C-order bytes of a tensor of any dtype; a card tensor is read to
    the host once."""
    flat = torch.as_tensor(t).detach().reshape(-1).contiguous().cpu()
    return flat.view(torch.uint8).numpy().tobytes() if flat.numel() else b""


class WireTensor:
    """A payload in wire layout (a flat 1-D tensor) that still presents its
    logical ``shape`` and ``dtype`` to the graph.

    The JAX package's ``tensor_upload`` makes these: a flat host→TPU
    transfer avoids the tiled-layout padding.  The port's upload sends
    logical tensors (the card has no such padding), so nothing in the port
    makes one; the class keeps the interface for code that receives one.
    ``np.asarray`` and :meth:`tensor` give the logical array.
    """

    __slots__ = ("data", "shape", "dtype")

    def __init__(self, data, shape: Tuple[int, ...], dtype):
        self.data = data  # flat torch tensor, host or card
        self.shape = tuple(int(d) for d in shape)
        self.dtype = numpy_dtype(dtype)

    def tensor(self) -> torch.Tensor:
        """The logical tensor: a view of ``data``, where ``data`` lies."""
        return self.data.view(self.shape)

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            # a wire payload always needs a copy to become a numpy array;
            # refusing here keeps a believed zero-copy path honest
            raise ValueError("WireTensor cannot be materialized without a copy")
        arr = self.tensor().detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None and arr.dtype != dtype else arr

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of unsized WireTensor")
        return self.shape[0]

    def __getitem__(self, key):
        return self.tensor()[key]

    def __repr__(self) -> str:
        return f"WireTensor({self.dtype}{self.shape})"


@dataclasses.dataclass
class Event:
    """In-band stream event (EOS, stream-start, flush, caps)."""

    kind: str
    payload: Any = None

    @classmethod
    def eos(cls) -> "Event":
        return cls("eos")

    @classmethod
    def caps(cls, spec) -> "Event":
        """Mid-stream spec change; ``payload`` is the new fixed spec."""
        return cls("caps", spec)


EOS = Event.eos()
