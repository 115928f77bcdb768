"""Filter-backend protocol and registry (``GstTensorFilterFramework``).

A backend owns a loaded model: ``open``/``close``, its input and output
specs (:meth:`FilterBackend.input_spec`, :meth:`FilterBackend.output_spec`),
the declared input spec (:meth:`FilterBackend.model_spec`),
:meth:`FilterBackend.reconfigure` (``setInputDimension``: fix the input
spec, get the output spec) and :meth:`FilterBackend.invoke`
(``invoke_NN``).

Built-in frameworks register lazily (:data:`_BUILTIN_MODULES`): ``torch``
and ``torch-cpu`` (``torch_backend.py``), ``custom``, ``custom-python`` and
``custom-easy`` (``custom.py``), ``custom-so`` (``custom_so.py``).  A name
still unknown then loads the external plugins (``conf.py``) and is looked
up once more.
"""

from __future__ import annotations

import importlib
import threading
from typing import Dict, Optional, Tuple

from ..spec import TensorsSpec


class FilterBackend:
    """Base class for model backends."""

    name: str = "base"

    def open(self, model, custom: str = "") -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def input_spec(self) -> Optional[TensorsSpec]:
        """The model's input signature; None if unknown until reconfigure."""
        return None

    def output_spec(self) -> Optional[TensorsSpec]:
        return None

    def model_spec(self) -> Optional[TensorsSpec]:
        """The model's declared (possibly partial) input spec: the
        negotiation template, which never narrows to the last negotiated
        spec."""
        return self.input_spec()

    def reconfigure(self, in_spec: TensorsSpec) -> TensorsSpec:
        """Adapt to a caller-imposed input spec; return the output spec.
        The default takes a stream its input spec accepts and gives its
        output spec.  Raises ValueError when the model cannot take it."""
        mine = self.input_spec()
        if mine is not None and mine.intersect(in_spec) is None:
            raise ValueError(f"backend {self.name}: input spec {in_spec} incompatible with "
                             f"model spec {mine}")
        out = self.output_spec()
        if out is None:
            raise ValueError(f"backend {self.name}: output spec unknown")
        return out

    def invoke(self, tensors: Tuple) -> Tuple:
        raise NotImplementedError


_BACKENDS: Dict[str, type] = {}
_LOCK = threading.Lock()
_BUILTIN_MODULES = {
    "torch": "nnstreamer_tpu_torch.backends.torch_backend",
    "torch-cpu": "nnstreamer_tpu_torch.backends.torch_backend",
    "custom": "nnstreamer_tpu_torch.backends.custom",
    "custom-python": "nnstreamer_tpu_torch.backends.custom",
    "custom-easy": "nnstreamer_tpu_torch.backends.custom",
    "custom-so": "nnstreamer_tpu_torch.backends.custom_so",
}


def register_backend(name: str):
    """Class decorator: register a backend class under a framework name."""

    def deco(cls):
        with _LOCK:
            _BACKENDS[name] = cls
        cls.name = name
        return cls

    return deco


def get_backend(name: str) -> FilterBackend:
    cls = _BACKENDS.get(name)
    if cls is None and name in _BUILTIN_MODULES:
        importlib.import_module(_BUILTIN_MODULES[name])
        cls = _BACKENDS.get(name)
    if cls is None:
        from ..conf import lookup_with_plugin_fallback

        cls = lookup_with_plugin_fallback(lambda: _BACKENDS.get(name))
    if cls is None:
        raise ValueError(f"unknown filter framework {name!r}; known: {sorted(known_backends())}")
    return cls()


def known_backends():
    return set(_BACKENDS) | set(_BUILTIN_MODULES)
