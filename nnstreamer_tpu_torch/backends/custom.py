"""Custom filter backends: user code as a stream filter.

The port of the JAX package's ``backends/custom.py``, three variants:

- ``custom``: a Python object (the :class:`CustomFilterBase` protocol) or a
  bare callable passed as the model;
- ``custom-python``: a ``.py`` file defining ``class CustomFilter``, built
  with the filter's ``custom`` string when one is given
  (``tensor_filter framework=custom-python model=scaler.py custom=224x224``);
- ``custom-easy``: a named (callable, input spec, output spec) triple,
  registered with :func:`register_custom_easy`.

The user's ``invoke`` gets the frame's torch tensors where they are, on the
host or on the card, and returns a tensor or a tuple of them (numpy arrays
are taken as host tensors).  An empty tuple drops the frame.  A bare
callable with no specs is probed once at negotiation with zero tensors on
the CPU, as the JAX package probes with numpy zeros.
"""

from __future__ import annotations

import importlib.util
import os
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..spec import TensorsSpec, torch_dtype
from .base import FilterBackend, register_backend


class CustomFilterBase:
    """Protocol for user filter objects (duck-typed; subclassing optional):

    - ``get_input_spec() -> TensorsSpec``   (optional with set_input_spec)
    - ``get_output_spec() -> TensorsSpec``  (optional with set_input_spec)
    - ``set_input_spec(in_spec) -> TensorsSpec``  (shape-polymorphic)
    - ``invoke(*tensors) -> tensor | tuple``
    """

    def get_input_spec(self) -> Optional[TensorsSpec]:
        return None

    def get_output_spec(self) -> Optional[TensorsSpec]:
        return None

    def invoke(self, *tensors):
        raise NotImplementedError


def _wrap_outputs(out) -> Tuple:
    outs = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    return tuple(torch.from_numpy(np.ascontiguousarray(o)) if isinstance(o, np.ndarray) else o
                 for o in outs)


class _ObjectBackend(FilterBackend):
    """Shared machinery: drive a CustomFilterBase-shaped object."""

    def __init__(self):
        self.obj = None

    def _bind(self, obj) -> None:
        if callable(obj) and not hasattr(obj, "invoke"):
            fn = obj

            class _CallableFilter(CustomFilterBase):
                def invoke(self, *tensors):
                    return fn(*tensors)

            obj = _CallableFilter()
        if not hasattr(obj, "invoke"):
            raise TypeError(f"custom filter object lacks invoke(): {obj!r}")
        self.obj = obj

    def close(self) -> None:
        self.obj = None

    def input_spec(self) -> Optional[TensorsSpec]:
        get = getattr(self.obj, "get_input_spec", None)
        return get() if get else None

    def output_spec(self) -> Optional[TensorsSpec]:
        get = getattr(self.obj, "get_output_spec", None)
        return get() if get else None

    def reconfigure(self, in_spec: TensorsSpec) -> TensorsSpec:
        setter = getattr(self.obj, "set_input_spec", None)
        if setter is not None:
            return setter(in_spec)
        if self.output_spec() is not None:
            return super().reconfigure(in_spec)
        # no spec at all (a bare callable): one call on zeros tells it
        if not in_spec.is_fixed:
            in_spec = in_spec.fixate()
        zeros = tuple(torch.zeros(t.shape, dtype=torch_dtype(t.dtype)) for t in in_spec.tensors)
        return TensorsSpec.from_arrays(self.invoke(zeros))

    def invoke(self, tensors: Tuple) -> Tuple:
        return _wrap_outputs(self.obj.invoke(*tensors))


@register_backend("custom")
class CustomBackend(_ObjectBackend):
    def open(self, model, custom: str = "") -> None:
        del custom
        self._bind(model)


@register_backend("custom-python")
class CustomPythonBackend(_ObjectBackend):
    def open(self, model, custom: str = "") -> None:
        path = os.fspath(model)
        spec = importlib.util.spec_from_file_location("nns_torch_custom_filter", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cls = getattr(mod, "CustomFilter", None)
        if cls is None:
            raise ValueError(f"{path}: no CustomFilter class found")
        self._bind(cls(custom) if custom else cls())


# -- custom-easy ------------------------------------------------------------

_EASY: Dict[str, tuple] = {}
_EASY_LOCK = threading.Lock()


def register_custom_easy(name: str, fn: Callable, in_spec: TensorsSpec,
                         out_spec: TensorsSpec) -> None:
    """Register a named easy filter (``NNS_custom_easy_register``)."""
    with _EASY_LOCK:
        _EASY[name] = (fn, in_spec, out_spec)


def unregister_custom_easy(name: str) -> None:
    with _EASY_LOCK:
        _EASY.pop(name, None)


@register_backend("custom-easy")
class CustomEasyBackend(_ObjectBackend):
    def open(self, model, custom: str = "") -> None:
        del custom
        key = os.fspath(model) if isinstance(model, os.PathLike) else str(model)
        try:
            fn, in_spec, out_spec = _EASY[key]
        except KeyError:
            raise ValueError(f"no custom-easy filter registered as {key!r}") from None

        class _Easy(CustomFilterBase):
            def get_input_spec(self):
                return in_spec

            def get_output_spec(self):
                return out_spec

            def invoke(self, *tensors):
                return fn(*tensors)

        self._bind(_Easy())
