"""Host staging for host→device copies, and the events that gate it.

The port's counterpart of the JAX package's ``pool.py``, cut to what
``tensor_upload`` needs.  The upload owns its staging slots outright (what
travels downstream is the device copy, never the slot), so the JAX
package's shared ``BufferPool`` and its ``fence`` wait for a second
consumer: the batch elements, with ``RowBatch``.

- :class:`WireStager`: ping-pong staging per tensor index, ``depth``
  (default 2) page-locked host tensors (``pin_memory=True``), each with the
  event of the copy that last read it.  Frame N+1 is copied into the other
  slot while frame N's copy is in flight; a slot is rewritten only after
  its event has completed.
- :func:`mark_ready` / :func:`wait_ready`: a device tensor made by an
  asynchronous copy on a side stream carries that copy's event.  Every
  node's dispatch of a frame calls :func:`wait_ready` on its tensors before
  ``process`` (``graph/node.py``): the current stream waits on the event,
  and ``record_stream`` keeps the caching allocator from reusing the block
  before the consumer's work is done.

On the CPU (``device="cpu"``, the tests) a slot is a plain tensor, there
is no event, and waits do nothing: a CPU copy is complete when it returns.
That is the explicit CPU path, not a fallback.
"""

from __future__ import annotations

from typing import Dict

import torch

_READY = "_nns_ready"  # attribute of a device tensor: its copy's event


class WireStager:
    """Ping-pong staging for host→device copies.

    ``stage(idx, x)`` copies host tensor ``x`` into one of ``depth`` slots
    for tensor index ``idx``, alternating slots; ``track(idx, event)``
    registers the event of the copy issued from the slot just staged.  A
    slot is rewritten only after that event has completed.
    """

    def __init__(self, depth: int = 2, pin: bool = False):
        self._depth = max(1, int(depth))
        self._pin = pin
        self._slots: Dict[int, dict] = {}

    def stage(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        slot = self._slots.get(idx)
        if slot is None:
            slot = self._slots[idx] = {"bufs": [None] * self._depth,
                                       "busy": [None] * self._depth, "turn": 0}
        k = slot["turn"] % self._depth
        slot["turn"] += 1
        slot["last"] = k
        event = slot["busy"][k]
        if event is not None:
            event.synchronize()  # the copy from this slot is done: rewrite it
            slot["busy"][k] = None
        buf = slot["bufs"][k]
        if buf is None or tuple(buf.shape) != tuple(x.shape) or buf.dtype != x.dtype:
            buf = slot["bufs"][k] = torch.empty(x.shape, dtype=x.dtype, pin_memory=self._pin)
        buf.copy_(x)
        return buf

    def track(self, idx: int, event) -> None:
        """Gate the last staged slot of ``idx`` on ``event``."""
        slot = self._slots.get(idx)
        if slot is not None and "last" in slot and event is not None:
            slot["busy"][slot["last"]] = event

    def reset(self) -> None:
        """Drop every slot (renegotiation, stop) once the copies still
        reading them have completed."""
        for slot in self._slots.values():
            for event in slot["busy"]:
                if event is not None:
                    event.synchronize()
        self._slots.clear()


def mark_ready(t: torch.Tensor, event) -> torch.Tensor:
    """Attach the event after which the device tensor ``t`` holds its data
    (the asynchronous copy that made it)."""
    if event is not None:
        setattr(t, _READY, event)
    return t


def wait_ready(t):
    """Before a consumer's first read of ``t``: its current stream waits for
    the copy that made ``t``, and the allocator keeps ``t``'s block until
    that stream's work is done.  Anything else passes unchanged."""
    event = getattr(t, _READY, None)
    if event is not None:
        stream = torch.cuda.current_stream(t.device)
        stream.wait_event(event)
        t.record_stream(stream)
    return t
