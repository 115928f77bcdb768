"""Element registry: name → factory (``gst_element_factory_make``).

Built-in elements register lazily: :func:`make` imports the defining
module on first lookup; a name still unknown then loads the external
plugins (``conf.py``) and is looked up once more.
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable, Dict, Optional

from .node import Node

_FACTORIES: Dict[str, Callable[..., Node]] = {}
_LOCK = threading.Lock()

_BUILTIN_MODULES: Dict[str, str] = {
    "videotestsrc": "nnstreamer_tpu_torch.elements.testsrc",
    "audiotestsrc": "nnstreamer_tpu_torch.elements.testsrc",
    "datasrc": "nnstreamer_tpu_torch.elements.testsrc",
    "tensor_converter": "nnstreamer_tpu_torch.elements.converter",
    "tensor_transform": "nnstreamer_tpu_torch.elements.transform",
    "tensor_filter": "nnstreamer_tpu_torch.elements.filter",
    "tensor_decoder": "nnstreamer_tpu_torch.elements.decoder",
    "tensor_sink": "nnstreamer_tpu_torch.elements.sink",
    "fakesink": "nnstreamer_tpu_torch.elements.sink",
    "tensor_aggregator": "nnstreamer_tpu_torch.elements.aggregator",
    "queue": "nnstreamer_tpu_torch.elements.queue",
    "tensor_upload": "nnstreamer_tpu_torch.elements.upload",
    "tensor_mux": "nnstreamer_tpu_torch.elements.mux",
    "tensor_demux": "nnstreamer_tpu_torch.elements.demux",
    "tee": "nnstreamer_tpu_torch.elements.tee",
    "tensor_merge": "nnstreamer_tpu_torch.elements.merge",
    "tensor_split": "nnstreamer_tpu_torch.elements.split",
    "tensor_reposink": "nnstreamer_tpu_torch.elements.repo",
    "tensor_reposrc": "nnstreamer_tpu_torch.elements.repo",
    "tensor_batch": "nnstreamer_tpu_torch.elements.batch",
    "tensor_unbatch": "nnstreamer_tpu_torch.elements.batch",
    "tensor_dynbatch": "nnstreamer_tpu_torch.elements.dynbatch",
    "tensor_dynunbatch": "nnstreamer_tpu_torch.elements.dynbatch",
    "valve": "nnstreamer_tpu_torch.elements.valve",
    "input-selector": "nnstreamer_tpu_torch.elements.selector",
    "output-selector": "nnstreamer_tpu_torch.elements.selector",
    "appsrc": "nnstreamer_tpu_torch.elements.app",
    "appsink": "nnstreamer_tpu_torch.elements.app",
    "tensor_crop": "nnstreamer_tpu_torch.elements.crop",
    "tensor_trainer": "nnstreamer_tpu_torch.elements.trainer",
    "tensor_query_client": "nnstreamer_tpu_torch.elements.query",
    "filesrc": "nnstreamer_tpu_torch.elements.file_io",
    "filesink": "nnstreamer_tpu_torch.elements.file_io",
    "tensor_save": "nnstreamer_tpu_torch.elements.save_load",
    "tensor_load": "nnstreamer_tpu_torch.elements.save_load",
    "tensor_debug": "nnstreamer_tpu_torch.elements.debug",
    "tensor_if": "nnstreamer_tpu_torch.elements.tensor_if",
    "tensor_rate": "nnstreamer_tpu_torch.elements.rate",
    "tensor_sparse_enc": "nnstreamer_tpu_torch.elements.sparse",
    "tensor_sparse_dec": "nnstreamer_tpu_torch.elements.sparse",
    "tensor_src_iio": "nnstreamer_tpu_torch.elements.iio_src",
}


def register_element(name: str) -> Callable:
    """Class decorator: register an element factory under a pipeline name."""

    def deco(cls):
        with _LOCK:
            _FACTORIES[name] = cls
        return cls

    return deco


def make(factory_name: str, /, element_name: Optional[str] = None, **props) -> Node:
    """Instantiate an element by registered name.  The instance name may
    come as ``name=`` or ``element_name=``."""
    factory = _FACTORIES.get(factory_name)
    if factory is None and factory_name in _BUILTIN_MODULES:
        importlib.import_module(_BUILTIN_MODULES[factory_name])
        factory = _FACTORIES.get(factory_name)
    if factory is None:
        from ..conf import lookup_with_plugin_fallback

        factory = lookup_with_plugin_fallback(lambda: _FACTORIES.get(factory_name))
    if factory is None:
        raise ValueError(
            f"unknown element {factory_name!r}; known: {sorted(known_elements())}"
        )
    if element_name is not None:
        props["name"] = element_name
    return factory(**props)


def known_elements():
    return set(_FACTORIES) | set(_BUILTIN_MODULES)
