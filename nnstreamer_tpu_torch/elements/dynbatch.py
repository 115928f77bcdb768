"""``tensor_dynbatch`` / ``tensor_dynunbatch``: adaptive batching in one
stream.

The port of the JAX package's ``elements/dynbatch.py``, in its thread mode
(the JAX package's dispatcher lanes are not ported).  Frames that pile up
behind a slow consumer coalesce into one batched invoke, while a stream
that keeps up stays at batch 1:

- ``tensor_dynbatch`` has its own worker thread and a bounded queue.  Each
  round it pops one frame, then drains whatever else is queued, up to
  ``max_batch``, and emits them as one ``(bucket, *shape)`` frame.
- Batch sizes round up to power-of-two buckets (padding repeats the last
  frame), so the filter downstream captures one CUDA graph per bucket
  (``backends/torch_backend.py``'s LRU; with ``[compile] warmup`` on,
  :meth:`DynBatch.warmup_plan` captures every bucket before PLAYING).  A
  ``max_batch`` that is not a power of two raises.
- Host rows are copied once each into a buffer leased from the shared
  pool (``pool.py``), page-locked when the consumer is on the card; rows
  on the card are stacked there.
- ``meta["dynbatch"]`` carries each frame's pts, duration and meta, and
  the batched frame gets a span with links to its frames' spans
  (``obs/spans.merge_context``); ``tensor_dynunbatch`` splits the result
  back into the frames (padding rows dropped) with their own timing.
- A caps event renegotiates this element on its worker, after the frames
  queued before it have left.

The model under the filter must take a leading batch dim of any size
(an input spec of shape ``(None, ...)``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from ..buffer import Event, Frame
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..native import OK, SHUTDOWN
from ..native.queue import make_frame_queue
from ..obs import hooks as _hooks
from ..obs import spans as _spans
from ..spec import TensorSpec, TensorsSpec

_POLL_MS = 100


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


def _meta(frames: List[Frame]) -> dict:
    return {"dynbatch": {"n": len(frames), "pts": [f.pts for f in frames],
                         "duration": [f.duration for f in frames],
                         "meta": [f.meta for f in frames]}}


@register_element("tensor_dynbatch")
class DynBatch(Node):
    def __init__(self, name: Optional[str] = None, max_batch: int = 8,
                 max_size_buffers: int = 64):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.max_batch = int(max_batch)
        if self.max_batch < 1 or (self.max_batch & (self.max_batch - 1)):
            # the buckets {1, 2, 4, ..., max_batch} bound the filter's captures
            raise ValueError(f"max_batch must be a power of two, got {self.max_batch}")
        self.max_size = int(max_size_buffers)
        self._q = None
        self.batches_emitted = 0
        self.frames_in = 0
        self._pool = None  # the shared pool, resolved on first use
        self._pin = False  # the consumer is on the card

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        if not spec.tensors_fixed:
            raise NegotiationError(f"{self.name}: dynbatch needs fixed upstream tensors, "
                                   f"got {spec}")
        out = tuple(TensorSpec(dtype=t.dtype, shape=(None,) + tuple(t.shape))
                    for t in spec.tensors)
        from ..graph.residency import consumer_platform

        self._pin = consumer_platform(self) == "cuda"
        # a None batch dim: the pads downstream skip the per-frame check,
        # and the backend takes each new bucket as a drift (its LRU)
        return {"src": TensorsSpec(tensors=out, rate=spec.rate)}

    def warmup_plan(self):
        """One capture a bucket, aimed at the filter downstream (hopping
        queue and upload): with warmup on, a pile-up's first flip to a new
        bucket never captures on the stream's path."""
        from ..graph.residency import downstream_filter_node

        spec = self.sink_pads["sink"].spec
        if spec is None or not spec.tensors_fixed:
            return []
        filt = downstream_filter_node(self)
        warm = getattr(filt, "warm_spec", None)
        if warm is None:
            return []
        buckets = [1 << i for i in range(self.max_batch.bit_length())]
        ensure = getattr(filt.backend, "ensure_cache_capacity", None)
        if ensure is not None:
            ensure(len(buckets) + 1)  # the ladder and the negotiated entry
        items = []
        for b in buckets:
            bspec = TensorsSpec(tensors=tuple(TensorSpec(dtype=t.dtype, shape=(b,) + tuple(t.shape))
                                              for t in spec.tensors), rate=spec.rate)
            items.append((f"bucket{b}", lambda s=bspec: warm(s)))
        return items

    def _ensure_queue(self):
        if self._q is None:
            self._q = make_frame_queue(self.max_size)

    def _dispatch(self, pad: Pad, item) -> None:
        del pad
        self._ensure_queue()
        self._q.push(item, leaky="no")

    def spawn_threads(self) -> List[threading.Thread]:
        self._ensure_queue()
        return [threading.Thread(target=self._worker, name=f"dynbatch:{self.name}")]

    def _pool_or_default(self):
        if self._pool is None:
            from ..pool import default_pool

            self._pool = default_pool()
        return self._pool

    def _stack(self, rows: List[torch.Tensor], b: int) -> torch.Tensor:
        """``rows`` and ``b - len(rows)`` repeats of the last as one tensor:
        stacked on the card, or each row copied once into a lease."""
        rows = rows + [rows[-1]] * (b - len(rows))
        if rows[0].device.type == "cuda":
            return torch.stack(rows)
        buf = self._pool_or_default().lease((b,) + tuple(rows[0].shape), rows[0].dtype,
                                            pin=self._pin)
        for i, r in enumerate(rows):
            buf[i].copy_(r)
        return buf

    def _emit_batch(self, frames: List[Frame]) -> None:
        b = _bucket(len(frames), self.max_batch)
        stacked = tuple(self._stack([f.tensors[i] for f in frames], b)
                        for i in range(frames[0].num_tensors))
        if _hooks.enabled:
            host = [t for t in stacked if t.device.type == "cpu"]
            _hooks.emit("copy", self, sum(t.nbytes for t in host),
                        sum(1 for t in host if getattr(t, "pool_fresh", False)))
        self._push_batch(stacked, frames, b)

    def _push_batch(self, tensors, frames: List[Frame], b: int) -> None:
        meta = _meta(frames)
        if _spans.enabled:
            # a span with links to each frame's span; their contexts ride
            # in meta["dynbatch"]["meta"] and tensor_dynunbatch restores them
            _spans.merge_context(frames, meta, self.name)
        self.frames_in += len(frames)
        self.batches_emitted += 1
        if _hooks.enabled:
            _hooks.emit("dynbatch_flush", self, len(frames), b)
        self.push(Frame(tensors=tensors, pts=frames[0].pts, duration=frames[0].duration,
                        meta=meta))

    def _worker(self) -> None:
        q = self._q
        max_pending = self.max_batch
        while True:
            status, item = q.pop(_POLL_MS)
            if status == SHUTDOWN:
                return
            if status != OK:
                continue
            try:
                if isinstance(item, Event):
                    if self._event(item):
                        return
                    continue
                pending = [item]
                while len(pending) < max_pending:  # what is queued already
                    status, nxt = q.pop(0)
                    if status != OK:
                        break
                    if isinstance(nxt, Event):
                        # an event never passes the frames queued before it
                        self._emit_batch(pending)
                        pending = []
                        if self._event(nxt):
                            return
                        break
                    pending.append(nxt)
                if pending:
                    self._emit_batch(pending)
            except BaseException as exc:  # noqa: BLE001 - any failure halts the graph
                if self.pipeline is not None:
                    self.pipeline.post_error(self, exc)
                return

    def _event(self, event: Event) -> bool:
        """An in-band event on the worker; True: the stream is over.  A caps
        event renegotiates this element, so the batched spec downstream
        follows the new frame spec."""
        sink = self.sink_pads["sink"]
        if event.kind == "eos":
            sink.eos = True
            self._on_eos()
            return True
        if event.kind == "caps":
            self._handle_caps(sink, event.payload)
        else:
            self.on_event(sink, event)
        return False

    def interrupt(self) -> None:
        if self._q is not None:
            self._q.shutdown()

    def stop(self) -> None:
        if self._q is not None:
            self._q.shutdown()
            self._q = None
        super().stop()


@register_element("tensor_dynunbatch")
class DynUnbatch(Node):
    """The inverse of :class:`DynBatch`: the batched frame back into its
    frames, by the ``dynbatch`` meta (padding rows dropped, each frame's
    timing and meta restored).  A batch on the card comes to the host in
    one copy a tensor."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        out = []
        for t in in_specs["sink"].tensors:
            if t.rank < 1:
                raise NegotiationError(f"{self.name}: expected batched tensors, got {t}")
            out.append(TensorSpec(dtype=t.dtype, shape=tuple(t.shape[1:])))
        return {"src": TensorsSpec(tensors=tuple(out), rate=in_specs["sink"].rate)}

    def process(self, pad: Pad, frame: Frame):
        del pad
        info = frame.meta.get("dynbatch")
        n = info["n"] if info else frame.tensors[0].shape[0]
        mats = [t.cpu() if isinstance(t, torch.Tensor) else t for t in frame.tensors]
        metas = info.get("meta") if info else None
        return [Frame(tensors=tuple(m[i] for m in mats),
                      pts=info["pts"][i] if info else frame.pts,
                      duration=info["duration"][i] if info else frame.duration,
                      meta=metas[i] if metas else {})
                for i in range(n)]
