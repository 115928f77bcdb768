"""``custom-so``: user C/C++ shared objects as filter backends.

The port of the JAX package's ``backends/custom_so.py``, with the same C
ABI (:file:`nnstreamer_tpu_torch/native/nns_custom_filter.h`, and the C++
class API :file:`nns_filter.hh` on top of it): a ``.so`` exporting
``nns_get_input_spec``, ``nns_get_output_spec`` and ``nns_invoke`` (and
optionally ``nns_init(custom)`` and ``nns_destroy``), loaded with
``ctypes.CDLL``.  Tensors cross the boundary as host buffers: an input on
the card is copied to the host for the call, as the JAX package's
``np.asarray`` copies a device array, and the outputs are CPU tensors
allocated from the declared output spec.  ``nns_invoke`` returning > 0
drops the frame; < 0 raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..spec import TensorSpec, TensorsSpec, numpy_dtype, torch_dtype
from .base import FilterBackend, register_backend

NNS_MAX_TENSORS = 16
NNS_MAX_RANK = 8

# enum nns_dtype, in the order of NNStreamer's _nns_tensor_type
_DTYPES = [np.int32, np.uint32, np.int16, np.uint16, np.int8, np.uint8,
           np.float64, np.float32, np.int64, np.uint64]
_DTYPE_CODE = {torch_dtype(np.dtype(d)): i for i, d in enumerate(_DTYPES)}


class _CTensorSpec(ctypes.Structure):
    _fields_ = [("dtype", ctypes.c_int32), ("rank", ctypes.c_uint32),
                ("dims", ctypes.c_uint64 * NNS_MAX_RANK)]


class _CTensorsSpec(ctypes.Structure):
    _fields_ = [("num_tensors", ctypes.c_uint32), ("tensors", _CTensorSpec * NNS_MAX_TENSORS)]


def _from_c_spec(cspec: _CTensorsSpec) -> TensorsSpec:
    if cspec.num_tensors > NNS_MAX_TENSORS:
        raise ValueError(f"custom-so: num_tensors {cspec.num_tensors} > {NNS_MAX_TENSORS}")
    tensors = []
    for i in range(cspec.num_tensors):
        t = cspec.tensors[i]
        if not 0 <= t.dtype < len(_DTYPES):
            raise ValueError(f"custom-so: bad dtype code {t.dtype}")
        if t.rank > NNS_MAX_RANK:
            raise ValueError(f"custom-so: tensor {i} rank {t.rank} > {NNS_MAX_RANK}")
        shape = tuple(int(t.dims[k]) for k in range(t.rank))
        tensors.append(TensorSpec(dtype=np.dtype(_DTYPES[t.dtype]), shape=shape))
    return TensorsSpec(tensors=tuple(tensors))


@register_backend("custom-so")
class CustomSoBackend(FilterBackend):
    def __init__(self):
        self._lib: Optional[ctypes.CDLL] = None
        self._in_spec: Optional[TensorsSpec] = None
        self._out_spec: Optional[TensorsSpec] = None

    def open(self, model, custom: str = "") -> None:
        path = os.fspath(model)
        lib = ctypes.CDLL(path)
        for sym in ("nns_get_input_spec", "nns_get_output_spec", "nns_invoke"):
            if not hasattr(lib, sym):
                raise ValueError(f"{path}: missing required export {sym}()")
        for sym in ("nns_get_input_spec", "nns_get_output_spec"):
            getattr(lib, sym).argtypes = [ctypes.POINTER(_CTensorsSpec)]
            getattr(lib, sym).restype = ctypes.c_int
        lib.nns_invoke.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64)]
        lib.nns_invoke.restype = ctypes.c_int
        if hasattr(lib, "nns_init"):
            lib.nns_init.argtypes = [ctypes.c_char_p]
            lib.nns_init.restype = ctypes.c_int
            rc = lib.nns_init(custom.encode())
            if rc != 0:
                raise RuntimeError(f"{path}: nns_init failed ({rc})")
        self._lib = lib
        specs = []
        for sym in ("nns_get_input_spec", "nns_get_output_spec"):
            cspec = _CTensorsSpec()
            if getattr(lib, sym)(ctypes.byref(cspec)) != 0:
                raise RuntimeError(f"{path}: {sym} failed")
            specs.append(_from_c_spec(cspec))
        self._in_spec, self._out_spec = specs

    def close(self) -> None:
        if self._lib is not None and hasattr(self._lib, "nns_destroy"):
            self._lib.nns_destroy()
        self._lib = None

    def input_spec(self) -> Optional[TensorsSpec]:
        return self._in_spec

    def output_spec(self) -> Optional[TensorsSpec]:
        return self._out_spec

    def invoke(self, tensors: Tuple) -> Tuple:
        # the ABI hands over exactly num_tensors buffers in spec order, of
        # the negotiated dtypes: a conforming .so reads that far
        ins = [torch.as_tensor(t).detach().cpu().contiguous() for t in tensors]
        expect = self._in_spec.tensors
        if len(ins) != len(expect):
            raise ValueError(f"custom-so: got {len(ins)} input tensors, spec has {len(expect)}")
        for i, (a, t) in enumerate(zip(ins, expect)):
            if _DTYPE_CODE.get(a.dtype) is None or a.dtype != torch_dtype(t.dtype):
                raise ValueError(f"custom-so: input {i} dtype {a.dtype} != negotiated "
                                 f"{numpy_dtype(t.dtype)}")
        outs = [torch.empty(t.shape, dtype=torch_dtype(t.dtype)) for t in self._out_spec.tensors]

        def bufs(ts):
            return ((ctypes.c_void_p * len(ts))(*[a.data_ptr() for a in ts]),
                    (ctypes.c_uint64 * len(ts))(*[a.numel() * a.element_size() for a in ts]))

        rc = self._lib.nns_invoke(*bufs(ins), *bufs(outs))
        if rc < 0:
            raise RuntimeError(f"custom-so invoke failed ({rc})")
        if rc > 0:
            return ()  # drop the frame
        return tuple(outs)
