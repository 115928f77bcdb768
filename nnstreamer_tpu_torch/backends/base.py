"""Filter-backend protocol and registry (``GstTensorFilterFramework``).

A backend owns a loaded model: ``open``/``close``, the declared input spec
(:meth:`FilterBackend.model_spec`), :meth:`FilterBackend.reconfigure`
(``setInputDimension``: fix the input spec, get the output spec) and
:meth:`FilterBackend.invoke` (``invoke_NN``).
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

    def model_spec(self) -> Optional[TensorsSpec]:
        """The model's declared (possibly partial) input spec: the
        negotiation template."""
        return None

    def reconfigure(self, in_spec: TensorsSpec) -> TensorsSpec:
        """Adapt to a caller-imposed input spec; return the output spec.
        Raises ValueError when the model cannot take it."""
        raise NotImplementedError

    def invoke(self, tensors: Tuple) -> Tuple:
        raise NotImplementedError


_BACKENDS: Dict[str, type] = {}
_LOCK = threading.Lock()
_BUILTIN_MODULES = {"torch": "nnstreamer_tpu_torch.backends.torch_backend"}


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
        raise ValueError(f"unknown filter framework {name!r}; known: {sorted(known_backends())}")
    return cls()


def known_backends():
    return set(_BACKENDS) | set(_BUILTIN_MODULES)
