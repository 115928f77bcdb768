"""``tensor_decoder``: tensor streams → media, via decoder subplugins.

``mode`` picks a decoder from the registry, ``option1..N`` parametrize it,
and the output spec comes from the subplugin.
"""

from __future__ import annotations

import importlib
import threading
from typing import Dict, List, Optional

from ..buffer import Frame
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..spec import TensorsSpec

_DECODERS: Dict[str, type] = {}
_LOCK = threading.Lock()
_BUILTIN = {
    "image_labeling": "nnstreamer_tpu_torch.decoders.image_label",
    "bounding_boxes": "nnstreamer_tpu_torch.decoders.bounding_boxes",
    "pose_estimation": "nnstreamer_tpu_torch.decoders.pose",
}


def register_decoder(name: str):
    def deco(cls):
        with _LOCK:
            _DECODERS[name] = cls
        cls.name = name
        return cls

    return deco


def get_decoder(name: str):
    cls = _DECODERS.get(name)
    if cls is None and name in _BUILTIN:
        importlib.import_module(_BUILTIN[name])
        cls = _DECODERS.get(name)
    if cls is None:
        from ..conf import lookup_with_plugin_fallback

        cls = lookup_with_plugin_fallback(lambda: _DECODERS.get(name))
    if cls is None:
        raise ValueError(f"unknown decoder mode {name!r}; known: {sorted(known_decoders())}")
    return cls()


def known_decoders():
    return set(_DECODERS) | set(_BUILTIN)


class DecoderPlugin:
    """Subplugin protocol: ``init(options)``, ``out_spec(in_spec)`` and
    ``decode(frame, in_spec) -> Frame``.

    A plugin may also offer the segment-compile lowering
    (``graph/segments.py``)::

        device_stage(in_spec) -> (fn, TensorsSpec) | None

    where ``fn(xs) -> tuple`` runs the decode's device part (argmax, box
    decode, NMS, ...) on the filter's output tensors, inside the filter's
    fused function, and the spec describes the small tensor it emits.  None
    refuses the lowering (sub-mode or shape not supported).  When a lowering
    is installed the planner calls :meth:`set_lowered` with that spec, and
    ``out_spec`` / ``decode`` then take the lowered tensor and run only the
    host tail (labels, overlay, meta); ``set_lowered(None)`` restores the
    full host decode on refusal or when the segment is undone.
    """

    name = "base"
    _lowered: Optional[TensorsSpec] = None

    def set_lowered(self, spec: Optional[TensorsSpec]) -> None:
        self._lowered = spec

    def init(self, options: List[str]) -> None:
        del options

    def out_spec(self, in_spec: TensorsSpec) -> TensorsSpec:
        raise NotImplementedError

    def decode(self, frame: Frame, in_spec: TensorsSpec) -> Frame:
        raise NotImplementedError


@register_element("tensor_decoder")
class TensorDecoder(Node):
    def __init__(self, name: Optional[str] = None, mode: str = "", **options):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        if not mode:
            raise ValueError("tensor_decoder requires mode=")
        self.mode = mode
        self.plugin = get_decoder(mode)
        opts: List[str] = [str(options.pop(f"option{i}", "")) for i in range(1, 10)]
        while opts and opts[-1] == "":
            opts.pop()
        if options:
            raise ValueError(f"unknown tensor_decoder properties: {sorted(options)}")
        self.options = tuple(opts)
        self.plugin.init(opts)
        self._in_spec: Optional[TensorsSpec] = None

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        in_spec = in_specs["sink"]
        self._in_spec = in_spec
        try:
            out = self.plugin.out_spec(in_spec)
        except ValueError as exc:
            raise NegotiationError(f"{self.name}: {exc}") from exc
        if out.rate is None and in_spec.rate is not None:
            out = TensorsSpec(tensors=out.tensors, rate=in_spec.rate)
        return {"src": out}

    def process(self, pad: Pad, frame: Frame):
        del pad
        return self.plugin.decode(frame, self._in_spec)
