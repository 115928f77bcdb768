"""Marshaling glue for the port's native C API (``native/capi``).

The port of the JAX package's ``api/capi_glue.py``.  The C library (the
analog of the reference's ``api/capi`` layer, ``nnstreamer-capi-single.c``
/ ``nnstreamer-capi-pipeline.c``) embeds CPython and calls only the
functions here, with plain types at the boundary: tensors travel as
``(bytes, dtype_name, shape_tuple)`` triples, one copy each way (the
reference's C API also copies at the app boundary,
``nnstreamer-capi-util.c`` ``ml_tensors_data_create``).

Inputs become host tensors (``device="cpu"`` of the single-shot or an
appsrc reaches the card as its pipeline moves it); an output on the card
is copied to the host once, here.  A bfloat16 tensor travels as its raw
16-bit words under the name ``"bfloat16"`` (``spec.dtype_name``), which
the JAX package's glue gives for its bfloat16 arrays too.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..spec import TensorSpec, TensorsSpec, dtype_from_name, dtype_name, torch_dtype
from .pipeline_api import PipelineHandle
from .single import SingleShot

Wire = Tuple[bytes, str, Tuple[int, ...]]


def _to_tensors(inputs: Sequence[Wire]) -> Tuple[torch.Tensor, ...]:
    """Host tensors of their own memory (one copy out of the C buffer)."""
    out = []
    for buf, dtype, shape in inputs:
        dt = torch_dtype(dtype_from_name(dtype))
        t = torch.frombuffer(bytearray(buf), dtype=dt) if len(buf) else torch.empty(0, dtype=dt)
        out.append(t.reshape(tuple(int(d) for d in shape)))
    return tuple(out)


def _to_wire(tensors: Sequence) -> List[Wire]:
    out = []
    for t in tensors:
        t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
        t = t.detach().cpu().contiguous()  # a card output: its one copy to the host
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        out.append((words.numpy().tobytes(), dtype_name(t.dtype),
                    tuple(int(d) for d in t.shape)))
    return out


def _spec_to_wire(spec: Optional[TensorsSpec]) -> Optional[List[Tuple[str, Tuple[int, ...]]]]:
    if spec is None:
        return None
    out = []
    for t in spec.tensors:
        dtype = dtype_name(t.dtype) if t.dtype is not None else ""
        shape = tuple(int(d) if d is not None else 0 for d in (t.shape or ()))
        out.append((dtype, shape))
    return out


def _spec_from_wire(info: Sequence[Tuple[str, Sequence[int]]]) -> TensorsSpec:
    return TensorsSpec(tensors=tuple(
        TensorSpec(dtype=dtype_from_name(dtype), shape=tuple(int(d) for d in shape))
        for dtype, shape in info))


# -- single-shot (ml_single_*) ----------------------------------------------

def single_open(framework: str, model: str, custom: str = "",
                input_info: Optional[Sequence] = None) -> SingleShot:
    """The single-shot on ``[filter] torch_device`` (``NNSTPU_FILTER_TORCH_DEVICE``),
    where a model from a file loads: the card by default."""
    from ..conf import conf

    spec = _spec_from_wire(input_info) if input_info else None
    return SingleShot(framework=framework, model=model, custom=custom, input_spec=spec,
                      device=conf.get("filter", "torch_device"))


def single_invoke(s: SingleShot, inputs: Sequence[Wire]) -> List[Wire]:
    return _to_wire(s.invoke(*_to_tensors(inputs)))


def single_input_info(s: SingleShot):
    return _spec_to_wire(s.input_spec())


def single_output_info(s: SingleShot):
    return _spec_to_wire(s.output_spec())


def single_set_timeout(s: SingleShot, ms: int) -> None:
    s.set_timeout(ms / 1000.0 if ms > 0 else None)


def single_set_input_info(s: SingleShot, info: Sequence) -> None:
    s.set_input_spec(_spec_from_wire(info))


def single_close(s: SingleShot) -> None:
    s.close()


# -- pipeline (ml_pipeline_*) ------------------------------------------------

def pipeline_construct(description: str) -> PipelineHandle:
    return PipelineHandle.construct(description)


def pipeline_start(h: PipelineHandle) -> None:
    h.start()


def pipeline_stop(h: PipelineHandle) -> None:
    h.stop()


def pipeline_destroy(h: PipelineHandle) -> None:
    h.destroy()


def pipeline_get_state(h: PipelineHandle) -> str:
    return h.get_state()


def pipeline_wait(h: PipelineHandle, timeout_ms: int) -> bool:
    return h.wait(timeout_ms / 1000.0 if timeout_ms > 0 else None)


def pipeline_sink_register(h: PipelineHandle, name: str,
                           trampoline: Callable[[List[Wire]], None]) -> Callable:
    """Register ``trampoline`` (a C-side callable taking the wire format)
    on sink ``name``; returns the Python-side callback for unregister."""
    def cb(frame):
        trampoline(_to_wire(frame.tensors))
    h.sink_register(name, cb)
    return cb


def pipeline_sink_unregister(h: PipelineHandle, name: str, cb: Callable) -> None:
    sink = h.sinks.get(name)
    if sink is not None and cb in getattr(sink, "callbacks", ()):
        sink.callbacks.remove(cb)


def pipeline_src_input(h: PipelineHandle, name: str, inputs: Sequence[Wire]) -> None:
    h.src_input(name, *_to_tensors(inputs))


def pipeline_src_eos(h: PipelineHandle, name: str) -> None:
    h.src_eos(name)


def pipeline_switch_select(h: PipelineHandle, name: str, pad: str) -> None:
    h.switch_select(name, pad)


def pipeline_switch_pads(h: PipelineHandle, name: str) -> List[str]:
    return h.switch_pads(name)


def pipeline_valve_set_open(h: PipelineHandle, name: str, open_: bool) -> None:
    h.valve_set_open(name, open_)
