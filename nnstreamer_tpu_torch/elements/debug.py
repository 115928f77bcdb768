"""``tensor_debug``: in-line stream inspection (a pass-through tap).

The port of the JAX package's ``elements/debug.py`` (upstream 2.x's
``tensor_debug``).  It records what flows, so that the hop that corrupted
a stream can be found:

- each frame's shapes, dtypes and pts (``ring`` holds the last
  ``capacity`` records); shape, dtype and size come from the tensor, with
  no copy to the host;
- ``checksum=true`` adds each tensor's byte sum as a uint64 (corruption
  across a transport: the sparse, protobuf and query hops); a card
  tensor's sum is computed on the card and read back as one integer;
- ``console=true`` logs a line a frame through the
  ``nnstreamer_tpu_torch.debug`` logger (off by default; a module handler
  prints to stdout when the application configures no logging);
- counters ``frames`` and ``bytes``; :meth:`TensorDebug.stats` sums them
  up (count, fps from the pts span, the last records).

Frames pass through untouched, as the same objects.
"""

from __future__ import annotations

import collections
import logging
import sys
import threading
from typing import Dict, Optional

import torch

from ..buffer import Frame, is_valid_ts
from ..graph.node import Node, Pad
from ..graph.registry import register_element
from ..spec import TensorsSpec, dtype_name
from ..utils.props import parse_bool


class _ConsoleHandler(logging.Handler):
    """print()-based: resolves ``sys.stdout`` when a record is emitted, so
    a redirection (pytest's capture, a daemon) is honored."""

    def emit(self, record):
        try:
            print(self.format(record), file=sys.stdout, flush=True)
        except Exception:  # noqa: BLE001 - the logging contract
            self.handleError(record)


_LOG = logging.getLogger("nnstreamer_tpu_torch.debug")
if not _LOG.handlers:
    _handler = _ConsoleHandler()
    _handler.setFormatter(logging.Formatter("%(message)s"))
    _LOG.addHandler(_handler)
    _LOG.setLevel(logging.INFO)


def byte_sum(t) -> int:
    """The sum of a tensor's bytes, where the tensor lies (one integer read
    back from the card); the JAX package's uint64 sum of the same bytes."""
    flat = torch.as_tensor(t).detach().reshape(-1).contiguous()
    if not flat.numel():
        return 0
    # int64 holds the sum of up to 2**55 bytes exactly, as uint64 does
    return int(flat.view(torch.uint8).sum(dtype=torch.int64))


@register_element("tensor_debug")
class TensorDebug(Node):
    def __init__(self, name: Optional[str] = None, capacity: int = 16, checksum: bool = False,
                 console: bool = False):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.checksum = parse_bool(checksum, name="checksum")
        self.console = parse_bool(console, name="console")
        self.ring = collections.deque(maxlen=self.capacity)
        self.frames = 0
        self.bytes = 0
        self._stamped = 0  # frames with a valid pts
        self._first_pts = None
        self._last_pts = None
        # not self._lock: the node's dispatch holds that around process()
        self._stats_lock = threading.Lock()

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        return {"src": in_specs["sink"]}

    def process(self, pad: Pad, frame: Frame):
        del pad
        rec = {"pts": frame.pts,
               "tensors": tuple(f"{dtype_name(t.dtype)}{tuple(int(d) for d in t.shape)}"
                                for t in frame.tensors)}
        nbytes = sum(int(t.nbytes) for t in frame.tensors)
        if self.checksum:
            rec["checksum"] = tuple(byte_sum(t) for t in frame.tensors)
        with self._stats_lock:
            self.frames += 1
            rec["n"] = self.frames
            self.bytes += nbytes
            self.ring.append(rec)
            if is_valid_ts(frame.pts):
                self._stamped += 1
                if self._first_pts is None:
                    self._first_pts = frame.pts
                self._last_pts = frame.pts
            n = self.frames
        if self.console:
            _LOG.info("[%s] #%d pts=%s %s%s", self.name, n, frame.pts, " ".join(rec["tensors"]),
                      f" sum={rec['checksum']}" if self.checksum else "")
        return frame

    def stats(self) -> Dict[str, object]:
        """Everything seen so far; safe to call while the pipeline plays."""
        with self._stats_lock:
            out: Dict[str, object] = {"frames": self.frames, "bytes": self.bytes,
                                      "last": list(self.ring)}
            first, last, stamped = self._first_pts, self._last_pts, self._stamped
        if first is not None and last is not None and last > first and stamped > 1:
            # over the frames that carry a timestamp only
            out["fps_from_pts"] = round((stamped - 1) / ((last - first) / 1e9), 3)
        return out
