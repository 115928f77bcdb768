"""Stream buffers: the frames and events that flow through a pipeline.

The port's copy of the JAX package's ``buffer.py``.  A frame's payloads are
torch tensors, on the host (CPU) or on the card; elements that compute on
the card move a host frame there themselves.

Timestamps are integer nanoseconds; ``NONE_TS`` marks an absent one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

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

    def __repr__(self) -> str:
        shapes = ",".join(f"{t.dtype}{tuple(t.shape)}" for t in self.tensors)
        return f"Frame[{shapes} pts={self.pts}]"


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
