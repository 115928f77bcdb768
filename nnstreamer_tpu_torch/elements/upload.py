"""``tensor_upload``: the host→device copy, moved off the filter's thread.

The port of the JAX package's element.  In the canonical topology

    … ! tensor_upload ! queue ! tensor_filter ! …

it runs in the source's thread: it copies each host payload into a pinned
:class:`~nnstreamer_tpu_torch.pool.WireStager` slot, issues the host→device
copy ``non_blocking=True`` on a side stream of its own, records an event
after it and sends the device tensor downstream carrying that event
(:func:`~nnstreamer_tpu_torch.pool.mark_ready`).  The ``queue`` hands the
tensor to the filter's thread, whose dispatch of the frame waits on the
event before the filter's first read
(:func:`~nnstreamer_tpu_torch.pool.wait_ready`, called by every node's
``_dispatch``, so a sink or a decoder fed straight from here waits too).
The copy of frame N+1 then overlaps the filter's work on frame N.

The target device is that of the first filter downstream (hopping queues
and uploads, ``graph/residency.py``), else the card.  A tensor already on
that device passes unchanged; on the CPU (a filter asked for
``device="cpu"``) nothing moves.

Spec-transparent: logical shapes and dtypes pass as they are (the JAX
package's flat wire layout is a TPU transfer trick the card does not
need).  Transform fusion and the segment planner hop over this element
(``graph/optimize.py``), so ``transform → upload → queue → filter`` still
folds into one call, fed the raw uint8 frame.

A page-locked lease of the shared pool (``tensor_batch`` and
``tensor_dynbatch`` assemble their batches in one) is copied from as it
is, with no staging copy, and fenced with the copy's event
(:func:`~nnstreamer_tpu_torch.pool.fence`): the pool hands the buffer out
again only after the copy has read it.

Each staging copy fires the ``copy`` hook with its bytes and whether it
allocated its slot (0 once the two slots are warm).  The port stages every
host frame, where the JAX package stages only a strided one (a contiguous
frame goes to ``jax.device_put`` as it is), so the ``copies`` tracer counts
one host copy per uploaded tensor that is not a lease here and none
there.  Not ported yet: the sharded wire rule (``_sharding_for``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..buffer import Frame
from ..device import resolve_device
from ..graph.node import Node, Pad
from ..graph.registry import register_element
from ..obs import hooks as _hooks
from ..pool import WireStager, fence, mark_ready
from ..spec import TensorsSpec


@register_element("tensor_upload")
class TensorUpload(Node):
    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.device: Optional[torch.device] = None
        self._stream = None  # the side stream the copies run on
        self._stager: Optional[WireStager] = None

    def _target_device(self) -> torch.device:
        from ..graph.residency import downstream_backend

        dev = getattr(downstream_backend(self), "device", None)
        return dev if dev is not None else resolve_device("cuda")

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        self.device = self._target_device()
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            if self._stream is None or self._stream.device != self.device:
                self._stream = torch.cuda.Stream(self.device)
            if self._stager is None:
                self._stager = WireStager(pin=True)
            else:
                self._stager.reset()  # the geometry may have changed
        return {"src": in_specs["sink"]}

    def process(self, pad: Pad, frame: Frame):
        del pad
        if self.device is None or self.device.type != "cuda":
            return frame  # the CPU: nothing to move
        out = []
        for i, t in enumerate(frame.tensors):
            if t.device == self.device:
                out.append(t)  # already there: nothing to move
                continue
            leased = hasattr(t, "_pool_lease") and t.is_pinned()
            if leased:
                src = t  # a batch element's page-locked lease: no staging copy
            else:
                src = self._stager.stage(i, t)
                if _hooks.enabled:
                    _hooks.emit("copy", self, src.numel() * src.element_size(),
                                self._stager.last_alloc)
            with torch.cuda.stream(self._stream):
                d = src.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            if leased:
                fence(t, event)  # no rewrite of the lease before the copy is done
            else:
                self._stager.track(i, event)
            out.append(mark_ready(d, event))
        return frame.with_tensors(out)

    def stop(self) -> None:
        if self._stager is not None:
            self._stager.reset()
        super().stop()
