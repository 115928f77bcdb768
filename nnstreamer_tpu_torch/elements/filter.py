"""``tensor_filter``: invokes a model on the stream.

The port of the JAX package's element: ``framework=`` picks a backend from
the registry (``torch``), the model opens on start, negotiation reconciles
the model's declared spec with the upstream stream spec and fails loudly on
a mismatch, and each frame's tensors go through the backend's ``invoke``
under ``torch.inference_mode()``.  Outputs stay on the backend's device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..backends.base import FilterBackend, get_backend
from ..buffer import Frame
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..spec import TensorsSpec


@register_element("tensor_filter")
class TensorFilter(Node):
    def __init__(
        self,
        name: Optional[str] = None,
        framework: str = "",
        model: object = None,
        custom: str = "",
        backend: Optional[FilterBackend] = None,
    ):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        if backend is not None:
            self.backend = backend
        else:
            if not framework:
                raise ValueError("tensor_filter requires framework=")
            self.backend = get_backend(framework)
        self.framework = framework or self.backend.name
        self.model = model
        self.custom = str(custom)
        self._opened = False

    def start(self) -> None:
        super().start()
        if not self._opened:
            self.backend.open(self.model, self.custom)
            self._opened = True

    def stop(self) -> None:
        if self._opened:
            self.backend.close()
            self._opened = False
        super().stop()

    def sink_spec(self, pad_name: str) -> TensorsSpec:
        del pad_name
        spec = self.backend.model_spec() if self._opened else None
        return spec or TensorsSpec()

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        in_spec = in_specs["sink"]
        try:
            out_spec = self.backend.reconfigure(in_spec)
        except ValueError as exc:
            raise NegotiationError(f"{self.name}: {exc}") from exc
        if in_spec.rate is not None and out_spec.rate is None:
            out_spec = TensorsSpec(tensors=out_spec.tensors, rate=in_spec.rate)
        return {"src": out_spec}

    def process(self, pad: Pad, frame: Frame):
        del pad
        with torch.inference_mode():
            outs = self.backend.invoke(frame.tensors)
        if not outs:
            return None
        return frame.with_tensors(outs)
