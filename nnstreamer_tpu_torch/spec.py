"""Tensor type system and stream-spec ("caps") negotiation algebra.

The port's copy of the JAX package's ``spec.py``: ``TensorSpec`` /
``TensorsSpec`` with partial specs (``None`` entries), ``intersect`` and
``fixate`` for two-phase negotiation, and the reference's dtype names.

Dtypes stay numpy dtypes, so a spec compares equal across the two packages;
:func:`torch_dtype` / :func:`numpy_dtype` map to and from the torch dtypes
that frames carry.  numpy has no bfloat16 of its own (the JAX package takes
one from ``ml_dtypes``), so the bfloat16 stream dtype is :data:`BFLOAT16`,
a dtype object of this module: its name is ``"bfloat16"`` in caps and dims
strings, its torch dtype is ``torch.bfloat16``, and its frames stay torch
tensors on the host too (a numpy view of one is its ``uint16`` bits,
``t.view(torch.uint16).numpy()``).

Shapes are numpy order (outermost first); :attr:`TensorSpec.nns_dims` gives
the reference's innermost-first ``d1:d2:d3:d4`` view, and
:meth:`TensorSpec.dims_string` / :meth:`TensorsSpec.to_caps_string` the
reference's wire strings.
"""

from __future__ import annotations

import dataclasses
import re
from fractions import Fraction
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

NNS_TENSOR_RANK_LIMIT = 4
NNS_TENSOR_SIZE_LIMIT = 16


class BFloat16DType:
    """The bfloat16 stream dtype: the attributes of a numpy dtype that spec
    code reads (``name``, ``str``, ``itemsize``, ``kind``), with no numpy
    type behind it.  :data:`BFLOAT16` is its one instance."""

    name = "bfloat16"
    str = "bfloat16"
    itemsize = 2
    kind = "f"

    def __repr__(self) -> str:
        return "dtype('bfloat16')"

    __str__ = __repr__


BFLOAT16 = BFloat16DType()

_DTYPE_NAMES = {
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
    "int16": np.dtype(np.int16),
    "uint16": np.dtype(np.uint16),
    "int32": np.dtype(np.int32),
    "uint32": np.dtype(np.uint32),
    "int64": np.dtype(np.int64),
    "uint64": np.dtype(np.uint64),
    "float32": np.dtype(np.float32),
    "float64": np.dtype(np.float64),
    "float16": np.dtype(np.float16),
    "bfloat16": BFLOAT16,
}

_NAME_BY_DTYPE = {v: k for k, v in _DTYPE_NAMES.items()}

_TORCH_BY_NAME = {
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "uint16": torch.uint16,
    "int32": torch.int32,
    "uint32": torch.uint32,
    "int64": torch.int64,
    "uint64": torch.uint64,
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}
_NP_BY_TORCH = {t: _DTYPE_NAMES[n] for n, t in _TORCH_BY_NAME.items()}


def supported_dtypes() -> Tuple[str, ...]:
    return tuple(_DTYPE_NAMES)


def dtype_from_name(name: str) -> np.dtype:
    """Parse a dtype name (the analog of ``gst_tensor_get_type``)."""
    try:
        return _DTYPE_NAMES[name.strip().lower()]
    except KeyError:
        raise ValueError(f"unknown tensor dtype name: {name!r}") from None


def dtype_name(dtype) -> str:
    """Canonical name for a numpy or torch dtype."""
    if dtype is None:
        raise ValueError("dtype is None")
    try:
        return _NAME_BY_DTYPE[numpy_dtype(dtype)]
    except KeyError:
        raise ValueError(f"unsupported tensor dtype: {dtype!r}") from None


def numpy_dtype(dtype) -> np.dtype:
    """The spec dtype of a numpy or torch dtype or a dtype name: a numpy
    dtype, or :data:`BFLOAT16` (also for ``ml_dtypes``' bfloat16, which the
    JAX package's specs carry)."""
    if isinstance(dtype, torch.dtype):
        try:
            return _NP_BY_TORCH[dtype]
        except KeyError:
            raise ValueError(f"unsupported tensor dtype: {dtype}") from None
    if dtype is BFLOAT16 or (isinstance(dtype, str) and dtype == "bfloat16"):
        return BFLOAT16
    if isinstance(dtype, np.dtype) and dtype.name == "bfloat16":
        return BFLOAT16
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a spec dtype (or dtype name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_BY_NAME[dtype_name(dtype)]


DimsLike = Sequence[Optional[int]]


def _normalize_dims(dims: Optional[DimsLike]) -> Optional[Tuple[Optional[int], ...]]:
    if dims is None:
        return None
    out = []
    for d in dims:
        if d is None:
            out.append(None)
        else:
            d = int(d)
            if d < 1:
                raise ValueError(f"tensor dimension must be >= 1, got {d}")
            out.append(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Type and shape of one tensor in a stream (``GstTensorInfo``).

    ``None`` means "not yet negotiated": the whole shape, or single dims.
    """

    dtype: Optional[np.dtype] = None
    shape: Optional[Tuple[Optional[int], ...]] = None
    name: Optional[str] = None

    def __post_init__(self):
        dtype = numpy_dtype(self.dtype) if self.dtype is not None else None
        object.__setattr__(self, "dtype", dtype)
        if dtype is not None and dtype not in _NAME_BY_DTYPE:
            raise ValueError(f"unsupported tensor dtype: {dtype}")
        object.__setattr__(self, "shape", _normalize_dims(self.shape))

    @property
    def is_fixed(self) -> bool:
        return (
            self.dtype is not None
            and self.shape is not None
            and all(d is not None for d in self.shape)
        )

    @property
    def rank(self) -> Optional[int]:
        return None if self.shape is None else len(self.shape)

    @property
    def num_elements(self) -> int:
        if not self.is_fixed:
            raise ValueError(f"spec not fixed: {self}")
        n = 1
        for d in self.shape:  # type: ignore[union-attr]
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        """Frame size in bytes."""
        return self.num_elements * self.dtype.itemsize  # type: ignore[union-attr]

    @property
    def nns_dims(self) -> Tuple[int, ...]:
        """Dims innermost first, padded with 1s to rank 4."""
        if self.shape is None or any(d is None for d in self.shape):
            raise ValueError(f"spec shape not fixed: {self}")
        dims = list(reversed(self.shape))  # type: ignore[arg-type]
        while len(dims) < NNS_TENSOR_RANK_LIMIT:
            dims.append(1)
        return tuple(dims)

    def dims_string(self) -> str:
        """``dim1:dim2:dim3:dim4``, innermost first."""
        return ":".join(str(d) for d in self.nns_dims)

    @classmethod
    def from_dims_string(cls, dims: str, dtype=None, name: Optional[str] = None) -> "TensorSpec":
        """Parse ``d1:d2:d3:d4`` (innermost first) into a numpy-order spec.
        Trailing 1s beyond the first dim are squeezed, so ``3:224:224:1``
        gives shape ``(224, 224, 3)``."""
        parts = [p for p in dims.strip().split(":") if p]
        if not parts or len(parts) > NNS_TENSOR_RANK_LIMIT:
            raise ValueError(f"bad dimension string: {dims!r}")
        nns = [int(p) for p in parts]
        if any(d < 1 for d in nns):
            raise ValueError(f"bad dimension string: {dims!r}")
        while len(nns) > 1 and nns[-1] == 1:
            nns.pop()
        if isinstance(dtype, str):
            dtype = dtype_from_name(dtype)
        return cls(dtype=dtype, shape=tuple(reversed(nns)), name=name)

    @classmethod
    def from_array(cls, arr) -> "TensorSpec":
        """Spec of a numpy array or torch tensor."""
        return cls(dtype=numpy_dtype(arr.dtype), shape=tuple(int(d) for d in arr.shape))

    def intersect(self, other: "TensorSpec") -> Optional["TensorSpec"]:
        """Greatest lower bound of two partial specs; None if incompatible."""
        if self.dtype is None:
            dtype = other.dtype
        elif other.dtype is None or other.dtype == self.dtype:
            dtype = self.dtype
        else:
            return None

        if self.shape is None:
            shape = other.shape
        elif other.shape is None:
            shape = self.shape
        elif len(self.shape) != len(other.shape):
            return None
        else:
            merged = []
            for a, b in zip(self.shape, other.shape):
                if a is None:
                    merged.append(b)
                elif b is None or a == b:
                    merged.append(a)
                else:
                    return None
            shape = tuple(merged)
        name = self.name if self.name is not None else other.name
        return TensorSpec(dtype=dtype, shape=shape, name=name)

    def is_compatible(self, other: "TensorSpec") -> bool:
        return self.intersect(other) is not None

    def fixate(self, default_dim: int = 1, default_dtype: str = "uint8") -> "TensorSpec":
        """Replace unknowns with defaults (caps fixation)."""
        dtype = self.dtype if self.dtype is not None else dtype_from_name(default_dtype)
        if self.shape is None:
            shape: Tuple[int, ...] = (default_dim,)
        else:
            shape = tuple(default_dim if d is None else d for d in self.shape)
        return TensorSpec(dtype=dtype, shape=shape, name=self.name)

    def validate_array(self, arr) -> None:
        """Check a tensor or array against this spec; raises on a mismatch."""
        got = TensorSpec.from_array(arr)
        if self.intersect(got) is None:
            raise ValueError(f"array {got} does not match spec {self}")

    def __str__(self) -> str:
        dt = dtype_name(self.dtype) if self.dtype is not None else "?"
        if self.shape is None:
            sh = "?"
        else:
            sh = "(" + ",".join("?" if d is None else str(d) for d in self.shape) + ")"
        nm = f" name={self.name}" if self.name else ""
        return f"TensorSpec[{dt} {sh}{nm}]"


@dataclasses.dataclass(frozen=True)
class TensorsSpec:
    """Spec of a frame: 1..16 tensors and a framerate (``GstTensorsConfig``).

    ``rate`` is frames/sec; ``None`` is unnegotiated, ``Fraction(0)`` means
    no natural rate.
    """

    tensors: Tuple[TensorSpec, ...] = ()
    rate: Optional[Fraction] = None

    def __post_init__(self):
        tensors = tuple(self.tensors)
        if len(tensors) > NNS_TENSOR_SIZE_LIMIT:
            raise ValueError(
                f"at most {NNS_TENSOR_SIZE_LIMIT} tensors per frame, got {len(tensors)}"
            )
        object.__setattr__(self, "tensors", tensors)
        if self.rate is not None:
            object.__setattr__(self, "rate", Fraction(self.rate))

    @classmethod
    def of(cls, *tensors: TensorSpec, rate: Optional[Fraction] = None) -> "TensorsSpec":
        return cls(tensors=tensors, rate=rate)

    @classmethod
    def from_arrays(cls, arrays: Iterable, rate: Optional[Fraction] = None) -> "TensorsSpec":
        return cls(tensors=tuple(TensorSpec.from_array(a) for a in arrays), rate=rate)

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    @property
    def tensors_fixed(self) -> bool:
        return len(self.tensors) > 0 and all(t.is_fixed for t in self.tensors)

    @property
    def is_fixed(self) -> bool:
        return self.tensors_fixed and self.rate is not None

    def intersect(self, other: "TensorsSpec") -> Optional["TensorsSpec"]:
        if self.tensors and other.tensors:
            if len(self.tensors) != len(other.tensors):
                return None
            merged = []
            for a, b in zip(self.tensors, other.tensors):
                m = a.intersect(b)
                if m is None:
                    return None
                merged.append(m)
            tensors = tuple(merged)
        else:
            tensors = self.tensors or other.tensors

        if self.rate is None:
            rate = other.rate
        elif other.rate is None or other.rate == self.rate:
            rate = self.rate
        else:
            return None
        return TensorsSpec(tensors=tensors, rate=rate)

    def is_compatible(self, other: "TensorsSpec") -> bool:
        return self.intersect(other) is not None

    def fixate(self) -> "TensorsSpec":
        rate = self.rate if self.rate is not None else Fraction(0)
        tensors = tuple(t.fixate() for t in self.tensors) or (TensorSpec().fixate(),)
        return TensorsSpec(tensors=tensors, rate=rate)

    # -- wire format: the reference's caps strings ---------------------------

    def to_caps_string(self) -> str:
        """``other/tensor`` caps for one tensor, ``other/tensors`` otherwise."""
        rate = self.rate if self.rate is not None else Fraction(0)
        rs = f"{rate.numerator}/{rate.denominator}"
        if len(self.tensors) == 1:
            t = self.tensors[0]
            return ("other/tensor, "
                    f"dimension=(string){t.dims_string()}, "
                    f"type=(string){dtype_name(t.dtype)}, "
                    f"framerate=(fraction){rs}")
        dims = ",".join(t.dims_string() for t in self.tensors)
        types = ",".join(dtype_name(t.dtype) for t in self.tensors)
        return ("other/tensors, "
                f"num_tensors=(int){len(self.tensors)}, "
                f"dimensions=(string){dims}, "
                f"types=(string){types}, "
                f"framerate=(fraction){rs}")

    @classmethod
    def from_caps_string(cls, caps: str) -> "TensorsSpec":
        """Parse a caps string of the form :meth:`to_caps_string` writes."""
        caps = caps.strip()
        head, _, rest = caps.partition(",")
        media = head.strip()
        if media not in ("other/tensor", "other/tensors"):
            raise ValueError(f"not a tensor caps string: {caps!r}")
        fields = {}
        for part in rest.split(","):
            key, _, val = part.strip().partition("=")
            val = val.strip()
            if val.startswith("("):  # "(string)", "(int)", "(fraction)"
                val = val.partition(")")[2]
            fields[key.strip()] = val
        rate = None
        if "framerate" in fields:
            num, _, den = fields["framerate"].partition("/")
            rate = Fraction(int(num), int(den) if den else 1)
        if media == "other/tensor":
            t = TensorSpec.from_dims_string(fields["dimension"], fields.get("type"))
            return cls(tensors=(t,), rate=rate)
        # the per-tensor lists are comma-separated themselves: read them
        # from the whole string
        return cls._parse_tensors_caps(caps, rate)

    @classmethod
    def _parse_tensors_caps(cls, caps: str, rate) -> "TensorsSpec":
        m_dims = re.search(r"dimensions=(?:\([a-z]+\))?([0-9:,]+)", caps)
        m_types = re.search(r"types=(?:\([a-z]+\))?([A-Za-z0-9_,]+?)(?:,\s*[a-z_]+=|$)", caps)
        m_num = re.search(r"num_tensors=(?:\([a-z]+\))?(\d+)", caps)
        if not (m_dims and m_types):
            raise ValueError(f"bad tensors caps string: {caps!r}")
        dims_list = [d for d in m_dims.group(1).split(",") if d]
        types_list = [t for t in m_types.group(1).split(",") if t]
        if len(dims_list) != len(types_list):
            raise ValueError(f"dims/types arity mismatch in caps: {caps!r}")
        if m_num and int(m_num.group(1)) != len(dims_list):
            raise ValueError(f"num_tensors mismatch in caps: {caps!r}")
        return cls(tensors=tuple(TensorSpec.from_dims_string(d, t)
                                 for d, t in zip(dims_list, types_list)), rate=rate)

    def __str__(self) -> str:
        ts = ", ".join(str(t) for t in self.tensors) or "?"
        r = "?" if self.rate is None else str(self.rate)
        return f"TensorsSpec[{ts} @ {r}fps]"


ANY = TensorsSpec()


def spec_of(*arrays, rate: Optional[Fraction] = None) -> TensorsSpec:
    return TensorsSpec.from_arrays(arrays, rate=rate)
