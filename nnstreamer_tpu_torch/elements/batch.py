"""``tensor_batch`` / ``tensor_unbatch``: N streams through one invoke.

The port of the JAX package's ``elements/batch.py``.  Behind
``tensor_mux`` they turn a frame of N same-spec tensors into one ``(N,
*shape)`` tensor, so that one filter invoke (one CUDA-graph replay) runs
every stream, and split the result back for ``tensor_demux``:

    src×N → tensor_mux → tensor_batch → … → tensor_filter → tensor_unbatch
          → tensor_demux → sink×N

``tensor_batch``:

- inputs on the card: one ``torch.stack`` there;
- host inputs: each row copied once into its slot of a buffer leased from
  the shared pool (``pool.py``), page-locked when the consumer is on the
  card, so that ``tensor_upload`` copies the whole batch with one
  asynchronous host→device copy straight from the lease.

``tensor_unbatch`` gives host consumers one device→host copy of the whole
batch and row views of it, and device consumers row views on the card
(``graph/residency.py::chain_device_resident``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..buffer import Frame
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..obs import hooks as _hooks
from ..spec import TensorSpec, TensorsSpec


@register_element("tensor_batch")
class TensorBatch(Node):
    def __init__(self, name: Optional[str] = None, pool=None):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._pool = pool  # the default shared pool unless one is given
        self._pin = False  # lease page-locked buffers: the consumer is on the card

    def _pool_or_default(self):
        if self._pool is None:
            from ..pool import default_pool

            self._pool = default_pool()
        return self._pool

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        if spec.num_tensors < 1:
            raise NegotiationError(f"{self.name}: needs at least one tensor")
        first = spec.tensors[0]
        for t in spec.tensors[1:]:
            if t.shape != first.shape or t.dtype != first.dtype:
                raise NegotiationError(
                    f"{self.name}: all tensors must share one spec to batch; got {t} vs {first}")
        out = TensorSpec(dtype=first.dtype, shape=(spec.num_tensors,) + tuple(first.shape))
        from ..graph.residency import consumer_platform

        self._pin = consumer_platform(self) == "cuda"
        return {"src": TensorsSpec(tensors=(out,), rate=spec.rate)}

    def process(self, pad: Pad, frame: Frame):
        del pad
        rows = frame.tensors
        if any(t.device.type == "cuda" for t in rows):
            return frame.with_tensors((torch.stack(rows),))  # stays on the card
        buf = self._pool_or_default().lease((len(rows),) + tuple(rows[0].shape), rows[0].dtype,
                                            pin=self._pin)
        for i, r in enumerate(rows):
            buf[i].copy_(r)
        if _hooks.enabled:
            _hooks.emit("copy", self, buf.nbytes, 1 if buf.pool_fresh else 0)
        return frame.with_tensors((buf,))


@register_element("tensor_unbatch")
class TensorUnbatch(Node):
    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._to_host = True

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        if spec.num_tensors != 1:
            raise NegotiationError(f"{self.name}: expects one batched tensor")
        t = spec.tensors[0]
        if t.rank < 1 or t.shape[0] is None:
            raise NegotiationError(f"{self.name}: batch dim must be fixed, got {t}")
        per = TensorSpec(dtype=t.dtype, shape=tuple(t.shape[1:]))
        from ..graph.residency import chain_device_resident

        self._to_host = not chain_device_resident(self, "down")
        return {"src": TensorsSpec(tensors=(per,) * t.shape[0], rate=spec.rate)}

    def process(self, pad: Pad, frame: Frame):
        del pad
        batched = frame.tensors[0]
        if batched.device.type == "cuda" and self._to_host:
            batched = batched.cpu()  # one copy of the whole batch
        return frame.with_tensors(torch.unbind(batched))
