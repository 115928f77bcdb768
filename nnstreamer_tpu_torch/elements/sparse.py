"""``tensor_sparse_enc`` / ``tensor_sparse_dec``: sparse tensor transport.

The port of the JAX package's ``elements/sparse.py`` (upstream 2.x's
sparse pair): a mostly-zero tensor (a segmentation mask, a one-hot frame,
pruned activations) crosses a boundary as (indices, values).

The format describes itself, in tensors only, so that a hop that drops
meta (the NNSQ wire carries tensors and pts) still decodes; the encoded
frame has three tensors:

1. ``header`` int64 ``[empty_flag, dtype_code, d0, d1, ...]``: the dense
   dtype (a code of the append-only table :data:`_DTYPES`) and shape;
2. ``indices`` int64, flat C-order positions of the non-zeros;
3. ``values`` in the dense dtype.

A value is a zero where ``x != 0`` is false: ``-0.0`` is dropped (and
decodes as ``+0.0``) and NaN is kept, as in the JAX package.  An all-zero
tensor sets ``empty_flag`` and carries one sentinel slot (the spec layer
forbids zero-sized dims).

Both run where the tensor lies: a card tensor is encoded with
``torch.nonzero`` on the card (its indices come in C order) and decoded
into a card tensor; a host tensor stays on the host.  The header, a few
integers, is made and read on the host either way.  Lengths vary by
frame, so both negotiate open specs: put them before sinks, queues and
query clients, not before a filter.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..buffer import Frame
from ..graph.node import NegotiationError, Node, Pad
from ..graph.registry import register_element
from ..spec import TensorSpec, TensorsSpec, dtype_name, numpy_dtype, torch_dtype

# dtype wire codes (a stable contract: append only), the spec layer's dtypes
_DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32", "int64",
           "uint64", "float32", "float64", "float16", "bfloat16")
_DTYPE_CODE = {name: i for i, name in enumerate(_DTYPES)}
# torch indexes no uint16/32/64 tensor: they are read and written through
# the signed integer of their width (the same bits, the same zeros)
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def _indexable(t: torch.Tensor) -> torch.Tensor:
    return t.view(_SIGNED[t.dtype]) if t.dtype in _SIGNED else t


@register_element("tensor_sparse_enc")
class SparseEnc(Node):
    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._in_spec: Optional[TensorSpec] = None
        self.frames_in = 0
        self.bytes_in = 0
        self.bytes_out = 0  # the achieved compression

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        if spec.num_tensors != 1:
            raise NegotiationError(f"{self.name}: sparse encoding is per-tensor; got "
                                   f"{spec.num_tensors} tensors/frame")
        self._in_spec = spec.tensors[0]
        if dtype_name(self._in_spec.dtype) not in _DTYPE_CODE:
            raise NegotiationError(f"{self.name}: unsupported dtype {self._in_spec.dtype} "
                                   f"(wire codes: {_DTYPES})")
        return {"src": TensorsSpec(
            tensors=(TensorSpec(dtype=np.int64, shape=(None,)),   # header
                     TensorSpec(dtype=np.int64, shape=(None,)),   # indices
                     TensorSpec(dtype=self._in_spec.dtype, shape=(None,))),
            rate=spec.rate)}

    def process(self, pad: Pad, frame: Frame):
        del pad
        self.frames_in += 1
        dense = torch.as_tensor(frame.tensor(0))
        flat = _indexable(dense.reshape(-1))
        nz = torch.nonzero(flat != 0).reshape(-1)  # NaN != 0 holds: NaN is kept
        empty = nz.numel() == 0
        if empty:
            idx = torch.zeros((1,), dtype=torch.int64, device=dense.device)
            vals = torch.zeros((1,), dtype=dense.dtype, device=dense.device)
        else:
            idx = nz
            vals = flat[nz].view(dense.dtype)
        header = torch.tensor([int(empty), _DTYPE_CODE[dtype_name(dense.dtype)]]
                              + [int(d) for d in dense.shape], dtype=torch.int64)
        self.bytes_in += dense.nbytes
        self.bytes_out += header.nbytes + idx.nbytes + vals.nbytes
        return Frame(tensors=(header, idx, vals), pts=frame.pts,
                     duration=frame.duration, meta=dict(frame.meta))


@register_element("tensor_sparse_dec")
class SparseDec(Node):
    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.frames_in = 0

    def configure(self, in_specs: Dict[str, TensorsSpec]) -> Dict[str, TensorsSpec]:
        spec = in_specs["sink"]
        if spec.num_tensors != 3:
            raise NegotiationError(f"{self.name}: expects (header, indices, values) frames "
                                   f"from tensor_sparse_enc; got {spec.num_tensors} tensors")
        for i in (0, 1):
            if numpy_dtype(spec.tensors[i].dtype) != np.int64:
                raise NegotiationError(f"{self.name}: tensor {i} must be int64, got "
                                       f"{spec.tensors[i].dtype}")
        # the dense shape rides in each frame's header
        return {"src": TensorsSpec(tensors=(TensorSpec(dtype=spec.tensors[2].dtype, shape=None),),
                                   rate=spec.rate)}

    def process(self, pad: Pad, frame: Frame):
        del pad
        self.frames_in += 1
        header = torch.as_tensor(frame.tensor(0)).detach().cpu()
        if header.dim() != 1 or header.numel() < 2:
            raise ValueError(f"{self.name}: malformed sparse header (size {header.numel()}; "
                             "upstream must be tensor_sparse_enc)")
        empty, code = int(header[0]), int(header[1])
        if not 0 <= code < len(_DTYPES):
            raise ValueError(f"{self.name}: unknown dtype code {code}")
        shape = tuple(int(d) for d in header[2:])
        if any(d <= 0 for d in shape):
            raise ValueError(f"{self.name}: bad dense shape {shape}")
        idx = torch.as_tensor(frame.tensor(1))
        n = 1
        for d in shape:
            n *= d
        dense = torch.zeros(n, dtype=torch_dtype(_DTYPES[code]), device=idx.device)
        if not empty:
            vals = torch.as_tensor(frame.tensor(2))
            if idx.numel() != vals.numel():
                raise ValueError(f"{self.name}: sparse frame has {idx.numel()} indices but "
                                 f"{vals.numel()} values (corrupt or truncated transport)")
            lo, hi = torch.stack([idx.min(), idx.max()]).tolist() if idx.numel() else (0, 0)
            if lo < 0 or hi >= n:
                raise ValueError(f"{self.name}: sparse indices out of range for shape {shape}")
            _indexable(dense)[idx] = _indexable(vals.to(dense.dtype))
        return Frame(tensors=(dense.reshape(shape),), pts=frame.pts, duration=frame.duration,
                     meta=dict(frame.meta))
