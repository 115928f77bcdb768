"""The PyTorch filter backend, ``framework="torch"``.

The port's counterpart of the JAX package's ``JaxModel`` / ``JaxBackend``
(``backends/jax_backend.py``): a model is an apply callable over params,
with its declared input spec.  PyTorch runs eagerly, so there is nothing to
compile: :meth:`TorchBackend.reconfigure` checks the negotiated spec and
works out the output spec, and :meth:`TorchBackend.invoke` moves the
frame's tensors to the model's device, runs the model there and leaves the
outputs on the device.

Transform fusion and whole-segment compilation (``graph/optimize.py``,
``graph/segments.py``) install a wrapper (:meth:`TorchBackend.set_wrapper`):
a function of the model call that runs the fused pre-stages, the model and
the fused post-stages (a decoder's device head among them) in one call, so
a frame goes from its raw stream tensors to the filter's last output
without a host synchronization.  ``segment_label`` names the folded region.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..device import resolve_device
from ..spec import TensorsSpec, torch_dtype
from .base import FilterBackend, register_backend


@dataclasses.dataclass
class TorchModel:
    """A model as the backend sees it: ``apply(params, *inputs)`` (an
    ``nn.Module`` works as ``apply`` with ``params=None``), its params, the
    declared input spec (``None`` dims are fixed at negotiation), the output
    spec when known, and the device the params live on."""

    apply: Callable
    params: Any = None
    input_spec: Optional[TensorsSpec] = None
    output_spec: Optional[TensorsSpec] = None
    name: str = "torch_model"
    device: Any = "cuda"

    def __call__(self, *xs):
        if isinstance(self.apply, torch.nn.Module):
            return self.apply(*xs)
        return self.apply(self.params, *xs)


def _as_tuple(outs) -> Tuple:
    return tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)


@register_backend("torch")
class TorchBackend(FilterBackend):
    def __init__(self):
        self.model: Optional[TorchModel] = None
        self.device: Optional[torch.device] = None
        self._out_spec: Optional[TensorsSpec] = None
        self._wrapper: Optional[Callable] = None
        self._fn: Optional[Callable] = None  # what invoke runs
        self.segment_label = ""

    def open(self, model, custom: str = "") -> None:
        del custom
        if isinstance(model, TorchModel):
            self.model = model
        elif callable(model):
            self.model = TorchModel(apply=model) if isinstance(model, torch.nn.Module) \
                else TorchModel(apply=lambda params, *xs: model(*xs))
        else:
            raise TypeError(f"unsupported model object: {type(model)}")
        self.device = resolve_device(self.model.device)
        self._out_spec = self.model.output_spec
        self.set_wrapper(self._wrapper)

    def close(self) -> None:
        self.model = None
        self._fn = None

    def model_spec(self) -> Optional[TensorsSpec]:
        return self.model.input_spec if self.model is not None else None

    def reconfigure(self, in_spec: TensorsSpec) -> TensorsSpec:
        mine = self.model_spec()
        if mine is not None:
            merged = mine.intersect(in_spec)
            if merged is None:
                raise ValueError(
                    f"torch backend: stream spec {in_spec} incompatible with "
                    f"model spec {mine}"
                )
            in_spec = merged
        if not in_spec.tensors_fixed:
            in_spec = in_spec.fixate()
        self._out_spec = self.trace_output_spec(in_spec)
        return self._out_spec

    def trace_output_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        """The bare model's output spec for a model input spec: the declared
        one, or else that of one trial run on zeros (no wrapper either way)."""
        if self.model.output_spec is not None:
            return self.model.output_spec
        with torch.inference_mode():
            xs = [torch.zeros(t.shape, dtype=torch_dtype(t.dtype), device=self.device)
                  for t in in_spec.tensors]
            return TensorsSpec.from_arrays(_as_tuple(self.model(*xs)))

    def set_wrapper(self, wrapper: Optional[Callable]) -> None:
        """Install a fn → fn wrapper around the model call (None: the bare
        model).  Eager PyTorch caches no compiled executable, so the wrapped
        function is simply rebuilt."""
        self._wrapper = wrapper
        if self.model is not None:
            self._fn = wrapper(self.model) if wrapper is not None else self.model

    def reconfigure_fused(self, raw_spec: TensorsSpec, out_spec: TensorsSpec) -> TensorsSpec:
        """Negotiate the wrapped function: it takes the raw stream spec and
        gives ``out_spec``, which the filter derived stage by stage (the
        JAX backend compiles here; eager PyTorch has nothing to build, and
        no trial run may launch the fused kernels before the first frame).
        The model-spec check already ran against the fused pre-stages'
        output (``TensorFilter._install_fusion``)."""
        if not raw_spec.tensors_fixed:
            raise ValueError(f"torch backend: fused input spec {raw_spec} is not fixed")
        self._out_spec = out_spec
        return out_spec

    def invoke(self, tensors: Tuple) -> Tuple:
        xs = [t.to(self.device) for t in tensors]
        return _as_tuple(self._fn(*xs))
